// K1: seed-chain DP, one warp per match list.
//
// Replaces the Pallas kernel flye_tpu/ops/chain_pallas.py `_make_kernel`
// (called from `_chain_dp_pallas`); the recurrence is that of
// flye_tpu/ops/chain.py `_chain_dp_scan`, which this kernel matches bit
// for bit:
//   score[i]  = max(k, max_j score[j] + min(dcur, dext, k) - gap)
//   over j in [i-L, i) with 0 < dcur, dext < max_jump,
//   gap       = 2*jd if jd > 100 else jd/2   (jd = |dcur - dext|)
//   parent[i] = the best j, the LATEST j on ties; -1 if best <= k;
//   row 0 scores k with no parent; lanes i >= nvalid get 0 / -1.
//
// What bounds it on an H100: the serial dependence along the match axis.
// Step i needs score[i-1], so a row is a chain of M dependent steps of
// L/32 predecessor checks per lane plus a 5-step shuffle reduction;
// the work per step is small and the step latency dominates.  The only
// parallelism is across rows: at T = 8 just 8 warps run and the card is
// almost idle; at T = 2048 there are enough warps to fill the SMs.
//
// Design: each warp keeps the last `ring` (>= L, a power of two) entries
// of cur, ext and score in a shared-memory ring (12 KB per warp at
// L = 1024), so the lookback window never touches device memory; the
// next match's coordinates are prefetched one step ahead to hide the
// one global load per step.  Lane l scores predecessors i-1-l,
// i-1-l-32, ... in descending order and keeps a strict maximum, so the
// larger j wins ties inside a lane; the shuffle reduction breaks ties by
// the larger j as well.  Exact int32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

__global__ void chain_dp_kernel(const int32_t* __restrict__ cur,
                                const int32_t* __restrict__ ext,
                                const int32_t* __restrict__ nvalid,
                                int32_t* __restrict__ score,
                                int32_t* __restrict__ parent, int T, int M,
                                int k, int max_jump, int L, int ring) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * warps + warp;
  if (t >= T) return;  // whole warp exits; no block-wide barrier below
  int32_t* rc = smem + (size_t)warp * 3 * ring;
  int32_t* re = rc + ring;
  int32_t* rs = re + ring;
  const int rmask = ring - 1;
  const int32_t* crow = cur + (size_t)t * M;
  const int32_t* erow = ext + (size_t)t * M;
  int32_t* srow = score + (size_t)t * M;
  int32_t* prow = parent + (size_t)t * M;
  int n = nvalid[t];
  n = n < 0 ? 0 : (n > M ? M : n);

  for (int i = n + lane; i < M; i += 32) {  // dead lanes
    srow[i] = 0;
    prow[i] = -1;
  }
  int ci = n > 0 ? crow[0] : 0;
  int ei = n > 0 ? erow[0] : 0;
  for (int i = 0; i < n; ++i) {
    const int cn = i + 1 < n ? crow[i + 1] : 0;
    const int en = i + 1 < n ? erow[i + 1] : 0;
    int best = kNeg, bj = -1;
    const int j0 = i - L > 0 ? i - L : 0;
    for (int j = i - 1 - lane; j >= j0; j -= 32) {
      const int s = j & rmask;
      const int dc = ci - rc[s];
      const int de = ei - re[s];
      if (dc > 0 && dc < max_jump && de > 0 && de < max_jump) {
        const int m = min(min(dc, de), k);
        const int jd = abs(dc - de);
        const int gap = jd > 100 ? 2 * jd : jd / 2;
        const int c = rs[s] + m - gap;
        if (c > best) {  // descending j: ties keep the larger j
          best = c;
          bj = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (ob > best || (ob == best && oj > bj)) {
        best = ob;
        bj = oj;
      }
    }
    const int ns = best > k ? best : k;
    if (lane == 0) {
      srow[i] = ns;
      prow[i] = best > k ? bj : -1;
      const int s = i & rmask;
      rc[s] = ci;
      re[s] = ei;
      rs[s] = ns;
    }
    __syncwarp();
    ci = cn;
    ei = en;
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
  int ring = 1;
  while (ring < L) ring <<= 1;
  const size_t per_warp = (size_t)3 * ring * sizeof(int32_t);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 200 * 1024) warps >>= 1;
  const size_t smem = warps * per_warp;
  cudaFuncSetAttribute(chain_dp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (T + warps - 1) / warps;
  chain_dp_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cur, (const int32_t*)ext, (const int32_t*)nvalid,
      (int32_t*)score, (int32_t*)parent, T, M, k, max_jump, L, ring);
  return (int)cudaGetLastError();
}
