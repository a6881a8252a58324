// K5: batched Levenshtein distance, one warp per sequence pair.
//
// Replaces the Pallas kernel flye_tpu/ops/align_pallas.py `_lev_kernel`
// (called from `_edit_distance_batch_pallas`); the function is that of
// flye_tpu_torch/ops/align.py `_edit_distance_plain`, which this kernel
// matches bit for bit:
//   out[p] = Levenshtein distance of a[p, :alen[p]] and b[p, :blen[p]]
//   (alen = 0 gives blen, blen = 0 gives alen; padded rows with both 0
//   give 0; 0 <= blen <= S, and alen > S gives 2^30 like the plain
//   version, whose answer row is then never reached).
//
// The DP over rows i = 1..alen of the previous row `prev`:
//   tmp[0] = i,  tmp[j] = min(prev[j-1] + (a[i-1] != b[j-1]), prev[j] + 1)
//   row[j] = min_{k <= j} (tmp[k] - k) + j
// so the in-row dependency (the insertion edge) is a prefix-min.
//
// What bounds it on an H100: integer throughput and step latency.  The least
// time is sum(alen * blen) cells x 7 int32 operations over the card's
// int32 rate (16.7 Tops/s); the 2*S input bytes of a pair are
// negligible beside that (3.35 TB/s).  But the rows of one pair are a
// chain of alen dependent steps, each of ceil(blen/32) dependent tiles
// (a 5-step shuffle scan plus the carry), so a pair's time is a latency
// chain and the card fills only when B is large (the S = 1024 bucket
// comes in batches of tens of pairs).
//
// Design: lane l of a warp owns the columns j = 32t + l + 1 of every
// tile t, so no lane ever reads a row value another lane wrote; the row
// lives in shared memory laid out tile-major (conflict-free), the pair's
// characters are staged into shared memory once, a[i-1] is a broadcast
// read.  Per tile, prev[j-1] comes from the neighbouring lane by a
// shuffle (from the previous tile's last lane for lane 0, kept in a
// register before that value is overwritten), the prefix-min runs as a
// 5-step warp scan, and the running minimum of the tiles before is
// carried in a register.  Only rows 1..alen and columns 1..blen are
// computed.  Exact int32 throughout.  Making it fast (Myers/Hyyro
// bit-parallel rows, several pairs per warp) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 29;        // above any distance
constexpr int kUnreached = 1 << 30;  // the plain version's "big"

__global__ void levenshtein_kernel(const uint8_t* __restrict__ a,
                                   const int32_t* __restrict__ alen,
                                   const uint8_t* __restrict__ b,
                                   const int32_t* __restrict__ blen,
                                   int32_t* __restrict__ out, int B, int S,
                                   int words_per_warp) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * warps + warp;
  if (p >= B) return;  // whole warp exits; no block-wide barrier below
  const int n = alen[p];
  const int m = blen[p];
  if (n > S) {
    if (lane == 0) out[p] = kUnreached;
    return;
  }
  if (n == 0 || m == 0) {
    if (lane == 0) out[p] = n + m;
    return;
  }
  const int tiles = (m + 31) >> 5;
  int32_t* row = smem + (size_t)warp * words_per_warp;  // [tiles][32]
  uint8_t* as = (uint8_t*)(row + ((S + 31) & ~31));
  uint8_t* bs = as + S;
  const uint8_t* arow = a + (size_t)p * S;
  const uint8_t* brow = b + (size_t)p * S;
  for (int k = lane; k < n; k += 32) as[k] = arow[k];
  for (int k = lane; k < m; k += 32) bs[k] = brow[k];
  for (int t = 0; t < tiles; ++t) {
    const int j = 32 * t + lane + 1;
    row[32 * t + lane] = j <= m ? j : kBig;  // row 0: prev[j] = j
  }
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    const int ai = as[i - 1];
    int diag = i - 1;  // prev[0]
    int carry = i;     // min_{k <= 32t} (tmp[k] - k), tmp[0] - 0 = i
    for (int t = 0; t < tiles; ++t) {
      const int j = 32 * t + lane + 1;
      const bool valid = j <= m;
      const int up = row[32 * t + lane];  // prev[j] (kBig past m)
      int left = __shfl_up_sync(kFull, up, 1);  // prev[j-1]
      if (lane == 0) left = diag;
      const int sub = valid ? (bs[j - 1] != ai) : 0;
      const int tmp = min(left + sub, up + 1);
      int g = tmp - j;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, g, off);
        if (lane >= off) g = min(g, o);
      }
      g = min(g, carry);
      diag = __shfl_sync(kFull, up, 31);  // prev[32(t+1)], read before
      carry = __shfl_sync(kFull, g, 31);  // any lane overwrites it
      if (valid) row[32 * t + lane] = g + j;
    }
  }
  if (lane == ((m - 1) & 31)) out[p] = row[m - 1];
}

}  // namespace

// a, b: uint8 [B, S]; alen, blen: int32 [B]; out: int32 [B] (fully
// written).  1 <= S <= 16384 (the segment buckets go to 1024; wider
// rows shrink the block to fit shared memory).  Returns
// cudaGetLastError() after the launch.
extern "C" int levenshtein_launch(const void* a, const void* alen,
                                  const void* b, const void* blen, void* out,
                                  int B, int S, void* stream) {
  if (B <= 0) return 0;
  // row (S rounded up to whole tiles) + both sequences, in 4-byte words
  const int words = ((S + 31) & ~31) + (2 * S + 3) / 4;
  const size_t per_warp = (size_t)words * sizeof(int32_t);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 200 * 1024) warps >>= 1;
  const size_t smem = warps * per_warp;
  cudaFuncSetAttribute(levenshtein_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (B + warps - 1) / warps;
  levenshtein_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const int32_t*)alen, (const uint8_t*)b,
      (const int32_t*)blen, (int32_t*)out, B, S, words);
  return (int)cudaGetLastError();
}
