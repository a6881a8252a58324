// K5: batched Levenshtein distance, Myers/Hyyro bit-parallel rows.
//
// Replaces the Pallas kernel flye_tpu/ops/align_pallas.py `_lev_kernel`
// (called from `_edit_distance_batch_pallas`); the function is that of
// flye_tpu_torch/ops/align.py `_edit_distance_plain`, which this kernel
// matches bit for bit:
//   out[p] = Levenshtein distance of a[p, :alen[p]] and b[p, :blen[p]]
//   (alen = 0 gives blen, blen = 0 gives alen; padded rows with both 0
//   give 0; 0 <= blen <= S, and alen > S gives 2^30 like the plain
//   version, whose answer row is then never reached).  The codes are any
//   uint8 values.
//
// Bit-parallel rows.  The DP row of a[i] over b's columns 1..m (m = blen)
// is held as two bit vectors, Pv and Mv: bit j set where D[i][j+1] -
// D[i][j] is +1, resp. -1 (Myers 1999; Hyyro's Levenshtein form).  One
// row of a costs ~11 word operations per 32 columns: the match mask Eq
// of a[i] over b, an add whose carry resolves the in-row (insertion)
// dependency, and shifts and logic.  Row 0 is Pv = all ones (D[0][j] = j),
// and every row enters with a horizontal delta of +1 at column 0 (D[i][0]
// = i).  After alen rows the distance is D[alen][m] = alen + the
// vertical deltas of columns 1..m, two popcounts.  Bits past m never
// reach them (carries and shifts only run upwards), so b's padding needs
// no mask.
//
// Match masks.  b's bytes give three bit planes per word: bit 0 of the
// code, bit 1, and "code >= 4".  A code c in 0..3 then has Eq = (L or ~L)
// & (H or ~H) & ~G, two xors and one 3-input logic op; any other code
// compares b's bytes with __vcmpeq4 (a correct general path, rare).
//
// Layout.  S <= 64: a thread per pair, one word (32 bits up to S = 32,
// else 64), 256 pairs a block; a warp runs as many rows as its longest
// pair, so the block hands its pairs to its threads sorted by alen (a
// counting sort in shared memory).  S > 64: G lanes per pair (G = S/64
// rounded up to a power of two, at most 32), WPL 64-bit words per lane
// (WPL > 1 only past S = 2048).  The word chain of a row runs up the
// lanes as a systolic wave: at step s lane g works on row s - g, its
// carry-in (the horizontal delta entering its first word) is lane g-1's
// carry-out of the step before, one shuffle a step.  A pair takes alen +
// (the lane holding column m) steps.  Each block stages its pairs'
// strings through shared memory with 16-byte loads.
//
// What bounds it on an H100: at the HiFi path's [2^23, 64] batches the 2 *
// 64 bytes a pair (1.07 GB, 0.32 ms at 3.35 TB/s) against ~11 operations
// per row and 32-bit word (2 words a row at S = 64) and the issue of
// the 64-bit forms of those operations.

// Anchored segments (`anchor_geometry_launch`, `anchor_rows_launch`; the
// plain versions are flye_tpu_torch/ops/align.py `_anchor_geometry_plain`
// and `_anchor_rows_plain`, matched bit for bit).  The overlap engine hands
// over a batch's anchors as one flat [N, 2] array, the overlap of each
// anchor and, per overlap, where its two strands start in the resident
// strands and how long they are.  `anchor_geometry` takes pair slot j to
// anchors j and j + 1 (a slot across two overlaps is empty), clamps each
// side to its strand as `_tile_segments` does and, with a run index,
// turns [lo, hi) into the run slice [run[lo], run[hi - 1]] of the
// compressed strand; it cuts a side longer than the widest bucket and
// charges the slot for it as `SegmentBatcher.run` does, and keys the slot
// by the bucket of its longer side.  `anchor_rows` gathers one bucket's
// slots (an index list ordered by key) from the resident codes into the
// [n, S] rows and lengths that K5 scores.  Both are memory-bound gathers:
// a thread per slot, and a thread per 4 columns of a row.

#include <cuda_runtime.h>
#include <stdint.h>

// the segment buckets of `anchor_geometry`, passed by value
struct Widths {
  int n;     // buckets, widest last
  int w[8];  // row widths, ascending
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnreached = 1 << 30;  // the plain version's "big"

// bytes (each 0 or 1) of x -> bits 0..3
__device__ __forceinline__ uint32_t nibble(uint32_t x01) {
  return (x01 * 0x01020408u) >> 24;
}

// b's code planes over the bits(Word) bytes at p (4-byte aligned)
template <typename Word>
__device__ __forceinline__ void code_planes(const uint8_t* p, Word& L,
                                            Word& H, Word& G) {
  constexpr int N = sizeof(Word) * 2;  // 4-byte groups
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
  L = H = G = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t x = q[k];
    L |= (Word)nibble(x & 0x01010101u) << (4 * k);
    H |= (Word)nibble((x >> 1) & 0x01010101u) << (4 * k);
    G |= (Word)nibble(__vcmpne4(x & 0xfcfcfcfcu, 0u) & 0x01010101u)
         << (4 * k);
  }
}

// the columns of the word at p whose code is c
template <typename Word>
__device__ __forceinline__ Word match_mask(int c, Word L, Word H, Word G,
                                           const uint8_t* p) {
  if (c < 4) {
    const Word mL = (c & 1) ? (Word)0 : ~(Word)0;
    const Word mH = (c & 2) ? (Word)0 : ~(Word)0;
    return (L ^ mL) & (H ^ mH) & ~G;
  }
  constexpr int N = sizeof(Word) * 2;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
  const uint32_t cc = (uint32_t)c * 0x01010101u;
  Word e = 0;
  for (int k = 0; k < N; ++k)
    e |= (Word)nibble(__vcmpeq4(q[k], cc) & 0x01010101u) << (4 * k);
  return e;
}

// One row on one word, with the horizontal delta hin in {-1, 0, +1}
// entering at its lowest column; returns the delta leaving its highest.
template <typename Word>
__device__ __forceinline__ int advance(Word& Pv, Word& Mv, Word Eq,
                                       int hin) {
  constexpr int kTop = 8 * sizeof(Word) - 1;
  const Word neg = hin < 0 ? (Word)1 : (Word)0;
  const Word Xv = Eq | Mv;
  Eq |= neg;
  const Word Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
  Word Ph = Mv | ~(Xh | Pv);
  Word Mh = Pv & Xh;
  const int hout = (int)(Ph >> kTop) - (int)(Mh >> kTop);
  Ph = (Ph << 1) | (Word)(hin > 0);
  Mh = (Mh << 1) | neg;
  Pv = Mh | ~(Xv | Ph);
  Mv = Ph & Xv;
  return hout;
}

// threads a block: 256 with a thread per pair, else 128
template <int G>
__host__ __device__ constexpr int block_threads() {
  return G == 1 ? 256 : 128;
}

// a pair's shared-memory row stride in bytes: the columns its words
// cover, plus one 4-byte word so that the stride is an odd number of
// words (a thread per pair reads its row's words without bank conflicts)
template <typename Word, int G, int WPL>
__host__ __device__ constexpr int row_stride() {
  return 4 * (G * WPL * (int)sizeof(Word) * 2 + 1);
}

// the bits of a word below column m (m - base of them, all past kBits)
template <typename Word>
__device__ __forceinline__ Word low_bits(int nbits) {
  constexpr int kBits = 8 * sizeof(Word);
  return nbits >= kBits ? ~(Word)0
                        : (nbits <= 0 ? (Word)0 : ((Word)1 << nbits) - 1);
}

template <typename Word>
__device__ __forceinline__ int popc(Word x) {
  if constexpr (sizeof(Word) == 8) {
    return __popcll(x);
  } else {
    return __popc(x);
  }
}

template <typename Word, int G, int WPL>
__global__ void __launch_bounds__(block_threads<G>())
    levenshtein_kernel(const uint8_t* __restrict__ a,
                       const int32_t* __restrict__ alen,
                       const uint8_t* __restrict__ b,
                       const int32_t* __restrict__ blen,
                       int32_t* __restrict__ out, int B, int S, int vec) {
  constexpr int kThreads = block_threads<G>();
  constexpr int PB = kThreads / G;  // pairs per block
  constexpr int kBits = 8 * sizeof(Word);
  constexpr int stride = row_stride<Word, G, WPL>();
  extern __shared__ uint32_t smem[];
  uint8_t* as = reinterpret_cast<uint8_t*>(smem);
  uint8_t* bs = as + (size_t)PB * stride;
  const int p0 = blockIdx.x * PB;
  const int np = min(PB, B - p0);
  if (vec) {  // S % 16 == 0 and both bases 16-byte aligned
    const int vpr = S / 16;
    const uint4* ga = reinterpret_cast<const uint4*>(a + (size_t)p0 * S);
    const uint4* gb = reinterpret_cast<const uint4*>(b + (size_t)p0 * S);
    for (int v = threadIdx.x; v < np * vpr; v += kThreads) {
      const int r = v / vpr;
      const int o = r * stride + 16 * (v - r * vpr);
      const uint4 x = ga[v], y = gb[v];
      uint32_t* da = reinterpret_cast<uint32_t*>(as + o);
      uint32_t* db = reinterpret_cast<uint32_t*>(bs + o);
      da[0] = x.x; da[1] = x.y; da[2] = x.z; da[3] = x.w;
      db[0] = y.x; db[1] = y.y; db[2] = y.z; db[3] = y.w;
    }
  } else {
    for (int v = threadIdx.x; v < np * S; v += kThreads) {
      const int r = v / S;
      const int o = r * stride + (v - r * S);
      as[o] = a[(size_t)p0 * S + v];
      bs[o] = b[(size_t)p0 * S + v];
    }
  }

  if constexpr (G == 1) {
    // A warp runs as many rows as its longest pair: hand the block's
    // pairs to its threads in order of their rows (a counting sort; the
    // rank within a count is arbitrary, each pair's result is its own).
    int* count = reinterpret_cast<int*>(bs + (size_t)PB * stride);  // [66]
    int* order = count + 66;                                        // [PB]
    if (threadIdx.x < 66) count[threadIdx.x] = 0;
    __syncthreads();
    const int t = threadIdx.x;
    int n = 0, m = 0, key = 0;
    if (t < np) {
      n = alen[p0 + t];
      m = blen[p0 + t];
      if (n > S) {
        out[p0 + t] = kUnreached;
      } else if (n == 0 || m == 0) {
        out[p0 + t] = n + m;
      } else {
        key = n;  // 1..64
      }
    }
    const int rank = atomicAdd(&count[key], 1);
    __syncthreads();
    if (threadIdx.x == 0) {  // exclusive prefix sums of the counts
      int acc = 0;
      for (int k = 0; k <= 64; ++k) {
        const int c = count[k];
        count[k] = acc;
        acc += c;
      }
    }
    __syncthreads();
    order[count[key] + rank] = t;
    __syncthreads();
    const int q = order[threadIdx.x];
    if (q >= np) return;
    n = alen[p0 + q];
    m = blen[p0 + q];
    if (n > S || n == 0 || m == 0) return;
    const uint8_t* arow = as + q * stride;
    const uint8_t* brow = bs + q * stride;
    Word L, H, Gp;
    code_planes<Word>(brow, L, H, Gp);
    Word Pv = ~(Word)0, Mv = 0;
    for (int i = 0; i < n; ++i)
      advance<Word>(Pv, Mv, match_mask<Word>(arow[i], L, H, Gp, brow), 1);
    // D[n][m] = D[n][0] + the vertical deltas of columns 1..m
    const Word mask = low_bits<Word>(m);
    out[p0 + q] = n + popc(Pv & mask) - popc(Mv & mask);
  } else {
    __syncthreads();
    const int pl = threadIdx.x / G;  // pair within the block
    const int g = threadIdx.x % G;   // lane within the pair's group
    const int p = p0 + pl;
    int n = 0, m = 0, steps = 0;
    if (pl < np) {
      n = alen[p];
      m = blen[p];
      if (n > S) {
        if (g == 0) out[p] = kUnreached;
      } else if (n == 0 || m == 0) {
        if (g == 0) out[p] = n + m;
      } else {
        steps = 1;
      }
    }
    const uint8_t* arow = as + pl * stride;
    const uint8_t* brow = bs + pl * stride;
    const int wm = steps ? (m - 1) / kBits : 0;  // word holding column m
    const int gm = wm / WPL;                     // the lane holding it
    if (steps) steps = n + gm;
    const int wsteps = __reduce_max_sync(kFull, steps);
    const bool live = steps && g <= gm;
    Word L[WPL], H[WPL], Gp[WPL], Pv[WPL], Mv[WPL];
#pragma unroll
    for (int w = 0; w < WPL; ++w) {
      Pv[w] = ~(Word)0;
      Mv[w] = 0;
      if (live)
        code_planes<Word>(brow + (g * WPL + w) * kBits, L[w], H[w], Gp[w]);
    }
    int hout = 0;
    for (int s = 0; s < wsteps; ++s) {
      const int up = __shfl_up_sync(kFull, hout, 1, G);
      const int i = s - g;
      if (live && i >= 0 && i < n) {
        const int c = arow[i];
        int h = g == 0 ? 1 : up;
#pragma unroll
        for (int w = 0; w < WPL; ++w) {
          const int wi = g * WPL + w;
          if (wi <= wm)
            h = advance<Word>(
                Pv[w], Mv[w],
                match_mask<Word>(c, L[w], H[w], Gp[w], brow + wi * kBits), h);
        }
        hout = h;
      }
    }
    // D[n][m] = D[n][0] + the vertical deltas of columns 1..m, summed over
    // the pair's lanes
    int d = 0;
    if (live) {
#pragma unroll
      for (int w = 0; w < WPL; ++w) {
        const Word mask = low_bits<Word>(m - (g * WPL + w) * kBits);
        d += popc(Pv[w] & mask) - popc(Mv[w] & mask);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(kFull, d, off, G);
    if (steps && g == 0) out[p] = n + d;
  }
}

template <typename Word, int G, int WPL>
int launch(const void* a, const void* alen, const void* b, const void* blen,
           void* out, int B, int S, cudaStream_t stream) {
  auto kern = levenshtein_kernel<Word, G, WPL>;
  constexpr int PB = block_threads<G>() / G;
  // both strings of each pair, then (a thread per pair) the sort's
  // counts and order
  const size_t smem = (size_t)2 * PB * row_stride<Word, G, WPL>() +
                      (G == 1 ? (66 + PB) * sizeof(int) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = S % 16 == 0 && (uintptr_t)a % 16 == 0 &&
                  (uintptr_t)b % 16 == 0;
  const int grid = (B + PB - 1) / PB;
  kern<<<grid, block_threads<G>(), smem, stream>>>(
      (const uint8_t*)a, (const int32_t*)alen, (const uint8_t*)b,
      (const int32_t*)blen, (int32_t*)out, B, S, vec);
  return (int)cudaGetLastError();
}

// one side of a slot: [p0, p1) clamped to the strand, as an offset into
// the codes and a length (0, 0 when empty)
__device__ __forceinline__ void anchor_side(int p0, int p1, int64_t base,
                                            int64_t n,
                                            const int32_t* __restrict__ run,
                                            int64_t& off, int& len) {
  const int64_t lo = min((int64_t)p0, n);
  const int64_t hi = max(min((int64_t)p1, n), lo);
  if (hi <= lo) {
    off = 0;
    len = 0;
  } else if (run == nullptr) {
    off = base + lo;
    len = (int)(hi - lo);
  } else {
    const int r0 = run[base + lo];
    off = r0;
    len = run[base + hi - 1] - r0 + 1;
  }
}

__global__ void anchor_geometry_kernel(
    const int32_t* __restrict__ anc, const int32_t* __restrict__ aov,
    const int64_t* __restrict__ ovm, const int32_t* __restrict__ a_run,
    const int32_t* __restrict__ b_run, int P, Widths widths,
    int64_t* __restrict__ a_off, int64_t* __restrict__ b_off,
    int32_t* __restrict__ al, int32_t* __restrict__ bl,
    int32_t* __restrict__ extra, int32_t* __restrict__ key) {
  const int top = widths.w[widths.n - 1];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < P;
       j += gridDim.x * blockDim.x) {
    const int o = aov[j];
    int64_t ao = 0, bo = 0;
    int la = 0, lb = 0;
    if (aov[j + 1] == o) {
      const int64_t* m = ovm + 4 * (int64_t)o;
      anchor_side(anc[2 * j], anc[2 * j + 2], m[0], m[1], a_run, ao, la);
      anchor_side(anc[2 * j + 1], anc[2 * j + 3], m[2], m[3], b_run, bo,
                  lb);
    }
    const int longer = max(la, lb);
    extra[j] = longer > top ? longer - min(top, min(la, lb)) : 0;
    la = min(la, top);
    lb = min(lb, top);
    int k = 0;
    if (la > 0 || lb > 0) {
      const int m = max(la, lb);
      k = 1;
      while (k < widths.n && widths.w[k - 1] < m) ++k;
    }
    a_off[j] = ao;
    b_off[j] = bo;
    al[j] = la;
    bl[j] = lb;
    key[j] = k;
  }
}

// four codes of a row from p (n of them live, zeros after)
__device__ __forceinline__ uint32_t gather4(const uint8_t* __restrict__ p,
                                            int n) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) x |= (uint32_t)p[i] << (8 * i);
  return x;
}

__global__ void anchor_rows_kernel(
    const uint8_t* __restrict__ a_codes, const uint8_t* __restrict__ b_codes,
    const int64_t* __restrict__ idx, int n, int S,
    const int64_t* __restrict__ a_off, const int64_t* __restrict__ b_off,
    const int32_t* __restrict__ al, const int32_t* __restrict__ bl,
    uint8_t* __restrict__ a_rows, uint8_t* __restrict__ b_rows,
    int32_t* __restrict__ alen, int32_t* __restrict__ blen) {
  const int q = S / 4;
  const int64_t total = (int64_t)n * q;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = t / q;
    const int c = 4 * (int)(t - r * q);
    const int64_t j = idx[r];
    const int la = al[j], lb = bl[j];
    reinterpret_cast<uint32_t*>(a_rows + r * S)[c / 4] =
        gather4(a_codes + a_off[j] + c, la - c);
    reinterpret_cast<uint32_t*>(b_rows + r * S)[c / 4] =
        gather4(b_codes + b_off[j] + c, lb - c);
    if (c == 0) {
      alen[r] = la;
      blen[r] = lb;
    }
  }
}

int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 65536 ? (blocks > 0 ? blocks : 1) : 65536);
}

}  // namespace

// anc: int32 [P + 1, 2]; aov: int32 [P + 1]; ovm: int64 [n_ov, 4] (a
// strand base, a strand length, b strand base, b strand length); a_run,
// b_run: int32 run index of each side's strands, or null without HPC.
// Writes P slots: int64 a_off, b_off; int32 al, bl, extra, key.
extern "C" int anchor_geometry_launch(const void* anc, const void* aov,
                                      const void* ovm, const void* a_run,
                                      const void* b_run, int P,
                                      Widths widths, void* a_off,
                                      void* b_off, void* al, void* bl,
                                      void* extra, void* key, void* stream) {
  if (P <= 0) return 0;
  if (widths.n < 1 || widths.n > 8) return (int)cudaErrorInvalidValue;
  anchor_geometry_kernel<<<grid_for(P, 256), 256, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)anc, (const int32_t*)aov, (const int64_t*)ovm,
      (const int32_t*)a_run, (const int32_t*)b_run, P, widths,
      (int64_t*)a_off, (int64_t*)b_off, (int32_t*)al, (int32_t*)bl,
      (int32_t*)extra, (int32_t*)key);
  return (int)cudaGetLastError();
}

// idx: int64 [n] slots of one bucket; S: its row width (a multiple of 4).
// Writes uint8 a_rows, b_rows [n, S] (zeros past each length) and int32
// alen, blen [n].
extern "C" int anchor_rows_launch(const void* a_codes, const void* b_codes,
                                  const void* idx, int n, int S,
                                  const void* a_off, const void* b_off,
                                  const void* al, const void* bl,
                                  void* a_rows, void* b_rows, void* alen,
                                  void* blen, void* stream) {
  if (n <= 0) return 0;
  if (S < 4 || S % 4) return (int)cudaErrorInvalidValue;
  anchor_rows_kernel<<<grid_for((int64_t)n * (S / 4), 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)a_codes, (const uint8_t*)b_codes, (const int64_t*)idx,
      n, S, (const int64_t*)a_off, (const int64_t*)b_off, (const int32_t*)al,
      (const int32_t*)bl, (uint8_t*)a_rows, (uint8_t*)b_rows,
      (int32_t*)alen, (int32_t*)blen);
  return (int)cudaGetLastError();
}

// a, b: uint8 [B, S]; alen, blen: int32 [B]; out: int32 [B] (fully
// written).  1 <= S <= 16384.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for S outside that range).
extern "C" int levenshtein_launch(const void* a, const void* alen,
                                  const void* b, const void* blen, void* out,
                                  int B, int S, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > 16384) return (int)cudaErrorInvalidValue;
  if (S <= 32) return launch<uint32_t, 1, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 64) return launch<uint64_t, 1, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 128) return launch<uint64_t, 2, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 256) return launch<uint64_t, 4, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 512) return launch<uint64_t, 8, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 1024)
    return launch<uint64_t, 16, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 2048)
    return launch<uint64_t, 32, 1>(a, alen, b, blen, out, B, S, st);
  if (S <= 4096)
    return launch<uint64_t, 32, 2>(a, alen, b, blen, out, B, S, st);
  if (S <= 8192)
    return launch<uint64_t, 32, 4>(a, alen, b, blen, out, B, S, st);
  return launch<uint64_t, 32, 8>(a, alen, b, blen, out, B, S, st);
}
