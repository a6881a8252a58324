// K1: seed-chain DP in 32-match tiles, a lane per match.
//
// Replaces the Pallas kernel flye_tpu/ops/chain_pallas.py `_make_kernel`
// (called from `_chain_dp_pallas`, chain_pallas.py:155); the recurrence
// is that of flye_tpu/ops/chain.py `_chain_dp_scan`, which this kernel
// matches bit for bit on any input, sorted or not:
//   score[i]  = max(k, max_j score[j] + min(dcur, dext, k) - gap)
//   over j in [i-L, i) with 0 < dcur, dext < max_jump,
//   gap       = 2*jd if jd > 100 else jd/2   (jd = |dcur - dext|)
//   parent[i] = the best j, the LATEST j on ties; -1 if best <= k;
//   row 0 scores k with no parent; lanes i >= nvalid get 0 / -1.
//
// What bounds it on an H100: the dependence along the match axis (step
// i needs every score before it) and the integer operations on the
// (match, predecessor) pairs scanned.  Rows are independent, so each
// row is a serial walk; the engine mostly hands over small batches
// (T = 8-128 rows), where a warp per row leaves the card nearly idle
// and the length of each row's dependent chain is the time.
//
// What the design does about it, without changing an output bit:
// - The admissible window.  A warp first checks whether its row is
//   non-decreasing in cur (else in ext) over [0, nvalid): the engine's
//   groups are sorted along one axis.  On a sorted axis every j below
//   the first j with key[i] - key[j] < max_jump is inadmissible, so the
//   scan for match i stops there (the exact difference of sorted int32
//   keys fits a uint32).  Rows sorted on neither axis scan the full
//   lookback.  On the paths' rows this leaves ~200-450 of 1,024.
// - Lane-per-match tiles.  Lane l owns match i0+l of a 32-match tile.
//   Phase A: every lane scans its own predecessors j < i0 (final
//   scores, in a shared-memory ring), descending with a strict maximum,
//   so the latest j wins ties; all lanes read the same slot (a
//   broadcast), eight slots loaded per step before any is used.
//   Phase B: 31 serial steps; at step m lane m's score is final and is
//   broadcast with one shuffle, and lanes l > m (with l - m <= L) take
//   the candidate j = i0+m on >=, later than any j before it.  Its
//   terms are computed before the serial steps, so a match costs one
//   shuffle, an add, a compare and two selects of dependent chain.
//   Everything is predicated, not branched: a warp never diverges.
// - Warps per row.  Up to kSplitRowsPerSM rows per SM, a block of
//   kWarpsMax warps walks one row: the warps take interleaved chunks
//   of phase A's window and merge their maxima (larger score, then
//   later j) through shared memory; warp 0 runs phase B.  Above that
//   a warp walks a row alone, several rows per block.
// The ring keeps cur/ext (int2) and score of the last `ring` matches
// (ring = next power of two >= max(L, 32); 12 KB at L = 1024); a
// tile's 32 entries are written after its phase A has read the slots
// they replace.  The next tile's coordinates are loaded into registers
// while the current tile runs, and scores and parents are stored once
// per tile, coalesced.  Exact int32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsMax = 4;
// rows per SM up to which a row gets kWarpsMax warps
constexpr int kSplitRowsPerSM = 4;

// Whether row[0..n) is non-decreasing; stops at the first chunk of 256
// pairs with a descent.  Loads are clamped into the row, not guarded,
// so the eight pairs of a chunk are in flight together.
__device__ bool row_sorted(const int32_t* __restrict__ row, int n,
                           int lane) {
  bool ok = true;
  for (int b = 0; b + 1 < n && __all_sync(kFull, ok); b += 256) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = b + 32 * u + lane;
      const int jc = min(j, n - 2);
      ok = ok & ((j + 1 >= n) | (row[jc] <= row[jc + 1]));
    }
  }
  return __all_sync(kFull, ok);
}

// The transition j -> i from the coordinate differences dcu, deu (as
// unsigned: two's complement, as the plain version's int32
// subtraction).  Admissible iff 0 < d < max_jump for both, i.e.
// d - 1 < mjm1 unsigned with mjm1 = max(max_jump - 1, 0); its term is
// min(dc, de, k) - gap.  Branch-free, and without signed overflow on
// the inadmissible pairs it is computed for and then ignores.
__device__ __forceinline__ bool admissible(unsigned dcu, unsigned deu,
                                           unsigned mjm1) {
  return (dcu - 1u < mjm1) & (deu - 1u < mjm1);
}

__device__ __forceinline__ unsigned term(unsigned dcu, unsigned deu,
                                         int k) {
  const int m = min(min((int)dcu, (int)deu), k);
  const unsigned jd = (int)dcu >= (int)deu ? dcu - deu : deu - dcu;
  return (unsigned)m - (jd > 100u ? 2u * jd : jd >> 1);
}

// One row, by the W warps of a block (W > 1; warp `wid`) or by one warp
// (W == 1).  kAxis: 0 no cut, 1 cur sorted, 2 ext sorted.  Every lane
// runs every step; what a lane must not do is masked by predicates, so
// no warp diverges between shuffles.
template <int kAxis, int W>
__device__ void chain_row(const int32_t* __restrict__ crow,
                          const int32_t* __restrict__ erow,
                          int32_t* __restrict__ srow,
                          int32_t* __restrict__ prow, int n, int k,
                          unsigned mj, unsigned mjm1, int L, int2* rce,
                          int32_t* rs, int rmask, int2* red, int wid,
                          int lane) {
  int ci = crow[min(lane, n - 1)];
  int ei = erow[min(lane, n - 1)];
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int nx = min(i + 32, n - 1);
    const int cn = crow[nx];  // next tile, in flight
    const int en = erow[nx];
    const bool mine = i < n;
    int best = kNeg, bj = -1;

    // phase A: predecessors j < i0, descending, in chunks of eight ring
    // slots (warp w takes chunks w, w + W, ...), each chunk loaded
    // before any slot is used; slots below the warp's last j hold other
    // matches and are masked by `live`
    const int jl = max(i - L, 0);   // this lane's last j
    const int jw = max(i0 - L, 0);  // lane 0's, the warp's last
    bool live = mine;
    for (int j = i0 - 1 - 8 * wid; j >= jw; j -= 8 * W) {
      int2 ce[8];
      int sc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = (j - u) & rmask;
        ce[u] = rce[s];
        sc[u] = rs[s];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const unsigned dcu = (unsigned)ci - (unsigned)ce[u].x;
        const unsigned deu = (unsigned)ei - (unsigned)ce[u].y;
        // on the sorted axis the difference only grows as j falls
        if (kAxis == 1) live = live & (dcu < mj);
        if (kAxis == 2) live = live & (deu < mj);
        live = live & (j - u >= jl);
        const int c = (int)((unsigned)sc[u] + term(dcu, deu, k));
        const bool take = live & admissible(dcu, deu, mjm1) & (c > best);
        best = take ? c : best;
        bj = take ? j - u : bj;
      }
      if (!__any_sync(kFull, live)) break;
    }
    if (W > 1) {
      red[wid * 32 + lane] = make_int2(best, bj);
      __syncthreads();
    }

    if (wid == 0) {
      // the warps' maxima: the larger score, then the later j
      for (int w = 1; w < W; ++w) {
        const int2 r = red[w * 32 + lane];
        const bool take = (r.x > best) | ((r.x == best) & (r.y > bj));
        best = take ? r.x : best;
        bj = take ? r.y : bj;
      }

      // phase B: predecessors inside the tile, in order.  The terms and
      // which transitions are allowed do not depend on the scores, so
      // they are computed first; the serial steps are one shuffle, an
      // add, a compare and two selects each.
      unsigned t[31];
      unsigned allowed = 0;
#pragma unroll
      for (int m = 0; m < 31; ++m) {
        const unsigned dcu =
            (unsigned)ci - (unsigned)__shfl_sync(kFull, ci, m);
        const unsigned deu =
            (unsigned)ei - (unsigned)__shfl_sync(kFull, ei, m);
        t[m] = term(dcu, deu, k);
        const bool ok = mine & (lane > m) & (lane - m <= L) &
                        admissible(dcu, deu, mjm1);
        allowed |= (unsigned)ok << m;
      }
#pragma unroll
      for (int m = 0; m < 31; ++m) {
        const int sm = __shfl_sync(kFull, best > k ? best : k, m);
        const int c = (int)((unsigned)sm + t[m]);
        const bool take = ((allowed >> m) & 1u) & (c >= best);
        best = take ? c : best;
        bj = take ? i0 + m : bj;
      }

      const int ns = best > k ? best : k;
      if (mine) {
        srow[i] = ns;
        prow[i] = best > k ? bj : -1;
      }
      __syncwarp();  // phase A's reads of the ring are done (W == 1)
      const int s = i & rmask;
      rce[s] = make_int2(ci, ei);
      rs[s] = ns;
    }
    if (W > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    ci = cn;
    ei = en;
  }
}

// W == 1: each warp of the block walks its own row, with its own ring.
// W > 1: the block's W warps walk one row (row = block), one ring and a
// [W, 32] exchange of phase A's maxima behind it.
template <int W>
__global__ void __launch_bounds__(32 * kWarpsMax)
chain_dp_kernel(const int32_t* __restrict__ cur,
                const int32_t* __restrict__ ext,
                const int32_t* __restrict__ nvalid,
                int32_t* __restrict__ score, int32_t* __restrict__ parent,
                int T, int M, int k, int max_jump, int L, int ring) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = W > 1 ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + warp;
  const int wid = W > 1 ? warp : 0;
  if (t >= T) return;  // whole warp (W > 1: whole block) exits
  int32_t* base = smem + (W > 1 ? 0 : (size_t)warp * 3 * ring);
  int2* rce = reinterpret_cast<int2*>(base);
  int32_t* rs = base + 2 * ring;
  int2* red = reinterpret_cast<int2*>(base + 3 * ring);
  const int32_t* crow = cur + (size_t)t * M;
  const int32_t* erow = ext + (size_t)t * M;
  int32_t* srow = score + (size_t)t * M;
  int32_t* prow = parent + (size_t)t * M;
  int n = nvalid[t];
  n = n < 0 ? 0 : (n > M ? M : n);

  for (int i = n + 32 * wid + lane; i < M; i += 32 * W) {  // dead lanes
    srow[i] = 0;
    prow[i] = -1;
  }
  const unsigned mj = max_jump > 0 ? (unsigned)max_jump : 0u;
  const unsigned mjm1 = max_jump > 1 ? (unsigned)(max_jump - 1) : 0u;
  const int rmask = ring - 1;
  if (n == 0) return;
  if (row_sorted(crow, n, lane)) {
    chain_row<1, W>(crow, erow, srow, prow, n, k, mj, mjm1, L, rce, rs,
                    rmask, red, wid, lane);
  } else if (row_sorted(erow, n, lane)) {
    chain_row<2, W>(crow, erow, srow, prow, n, k, mj, mjm1, L, rce, rs,
                    rmask, red, wid, lane);
  } else {
    chain_row<0, W>(crow, erow, srow, prow, n, k, mj, mjm1, L, rce, rs,
                    rmask, red, wid, lane);
  }
}

}  // namespace

// cur, ext: int32 [T, M]; nvalid: int32 [T]; score, parent: int32 [T, M]
// (outputs, fully written).  1 <= L <= 16384.  Returns
// cudaGetLastError() after the launch.
extern "C" int chain_dp_launch(const void* cur, const void* ext,
                               const void* nvalid, void* score,
                               void* parent, int T, int M, int k,
                               int max_jump, int L, void* stream) {
  if (T <= 0 || M <= 0) return 0;
  int ring = 32;
  while (ring < L) ring <<= 1;
  const size_t per_ring = (size_t)3 * ring * sizeof(int32_t);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int32_t* c = (const int32_t*)cur;
  const int32_t* e = (const int32_t*)ext;
  const int32_t* nv = (const int32_t*)nvalid;
  int32_t* sc = (int32_t*)score;
  int32_t* pa = (int32_t*)parent;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t split_smem = per_ring + (size_t)kWarpsMax * 32 * 8;
  if (T <= kSplitRowsPerSM * sms && split_smem <= 200 * 1024) {
    // few rows: kWarpsMax warps share each row's phase A
    cudaFuncSetAttribute(chain_dp_kernel<kWarpsMax>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)split_smem);
    chain_dp_kernel<kWarpsMax><<<T, 32 * kWarpsMax, split_smem, st>>>(
        c, e, nv, sc, pa, T, M, k, max_jump, L, ring);
    return (int)cudaGetLastError();
  }
  // many rows: a warp per row, as many per block as fit in 200 KB
  int warps = kWarpsMax;
  while (warps > 1 && warps * per_ring > 200 * 1024) warps >>= 1;
  const size_t smem = warps * per_ring;
  cudaFuncSetAttribute(chain_dp_kernel<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  chain_dp_kernel<1><<<(T + warps - 1) / warps, 32 * warps, smem, st>>>(
      c, e, nv, sc, pa, T, M, k, max_jump, L, ring);
  return (int)cudaGetLastError();
}
