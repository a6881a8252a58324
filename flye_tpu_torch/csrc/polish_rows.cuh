// Row code shared by K2+K3 (polish_score.cu) and K4 (polish_fused.cu):
// a branch's DP row held in the registers of LANES lanes (16: two
// branches a warp; 32: one), lane l owning the K contiguous columns
// l*K .. l*K+K-1, the suffix (K2) and prefix (K3) row steps with their
// segment scans, the scoring of one position, the reduction of a branch's
// 9 maxima, and the block's branch sums in branch order.  The arithmetic
// is the plain version's (ops/polish.py `_score_edits_raw`), so every
// kernel built from these pieces gives its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// n rounded up to whole 32-byte sectors of f32
__host__ __device__ inline int sector_pad(int n) { return (n + 7) & ~7; }

template <int N>
struct Int {
  static constexpr int value = N;
};

// fn(Int<K>()) for a warp's columns per lane k in 1..KC: K = k up to 4,
// then 6 and 8 (never past KC), so that every loop over a lane's columns
// runs exactly K times
template <int KC, typename Fn>
__device__ __forceinline__ void with_k(int k, Fn&& fn) {
  if (k <= 1) {
    fn(Int<1>());
  } else if (k == 2 || KC <= 2) {
    fn(Int<(KC >= 2 ? 2 : 1)>());
  } else if (k == 3 && KC >= 3) {
    fn(Int<(KC >= 3 ? 3 : 1)>());
  } else if (k == 4 || KC <= 4) {
    fn(Int<(KC >= 4 ? 4 : KC)>());
  } else if (k <= 6 && KC >= 6) {
    fn(Int<(KC >= 6 ? 6 : KC)>());
  } else {
    fn(Int<KC>());
  }
}

// Store a lane's K columns j0 .. j0+K-1 into a packed row (ldb: its live
// columns rounded up to a sector): 16-byte stores (K a multiple of 4) or
// an 8-byte one (K = 2), aligned since every packed row starts on a
// sector and stays inside it; K scalar ones otherwise.
template <int K, int KC>
__device__ __forceinline__ void store_cols(float* o, int j0, int ldb,
                                           const float (&v)[KC]) {
  if (j0 >= ldb) return;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4)
      *reinterpret_cast<float4*>(o + j0 + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(o + j0) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c)
      if (j0 + c < ldb) o[j0 + c] = v[c];
  }
}

// Load what store_cols stored: columns past bl read -1e30.
template <int K, int KC>
__device__ __forceinline__ void load_cols(const float* o, int j0, int ldb,
                                          int bl, float (&v)[KC]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4) {
      float4 x = make_float4(kNeg, kNeg, kNeg, kNeg);
      if (j0 < ldb) x = *reinterpret_cast<const float4*>(o + j0 + c);
      v[c] = x.x;
      v[c + 1] = x.y;
      v[c + 2] = x.z;
      v[c + 3] = x.w;
    }
  } else if constexpr (K == 2) {
    float2 x = make_float2(kNeg, kNeg);
    if (j0 < ldb) x = *reinterpret_cast<const float2*>(o + j0);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = j0 + c <= bl ? o[j0 + c] : kNeg;
  }
#pragma unroll
  for (int c = 0; c < K; ++c)
    if (j0 + c > bl) v[c] = kNeg;
}

// shuffles within a branch's LANES lanes (a lane past either end gets its
// own value back)
template <int LANES = 16>
__device__ __forceinline__ float seg_up(float v, int d) {
  return __shfl_up_sync(kFull, v, d, LANES);
}
template <int LANES = 16>
__device__ __forceinline__ float seg_down(float v, int d) {
  return __shfl_down_sync(kFull, v, d, LANES);
}
template <int LANES = 16>
__device__ __forceinline__ float seg_at(float v, int src) {
  return __shfl_sync(kFull, v, src, LANES);
}

// cand's character picks one of the four per-column match rows
template <int K, int KC>
__device__ __forceinline__ void pick_row(int ci, const float (&m)[4][KC],
                                         float (&mc)[KC]) {
#pragma unroll
  for (int c = 0; c < K; ++c)
    mc[c] = ci == 0 ? m[0][c] : ci == 1 ? m[1][c] : ci == 2 ? m[2][c] : m[3][c];
}

// One K2 row on the columns j0 .. j0+K-1 of each lane.  nxt holds
// B[i+1] there and becomes B[i]; right = B[i+1][j0+K]; carry = the
// suffix max of the columns right of this chunk.  Returns the suffix max
// of the chunk and all right of it (uniform over the branch's lanes).
template <int K, int KC, int LANES = 16>
__device__ __forceinline__ float backward_cols(float (&nxt)[KC],
                                               const float (&sgv)[KC],
                                               const float (&mc)[KC], int j0,
                                               int bl, float vg, float right,
                                               float carry, int l) {
  float v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int j = j0 + c;
    const float nr = c + 1 < K ? nxt[c + 1 < K ? c + 1 : c] : right;
    float tmp = nxt[c] + vg;
    if (j < bl) tmp = fmaxf(nr + mc[c], tmp);
    v[c] = j <= bl ? tmp - sgv[c] : kNeg;
  }
#pragma unroll
  for (int c = K - 2; c >= 0; --c) v[c] = fmaxf(v[c], v[c + 1]);
  float incl = v[0];
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1)
    incl = fmaxf(incl, seg_down<LANES>(incl, off));
  incl = fmaxf(incl, carry);
  float excl = seg_down<LANES>(incl, 1);
  if (l == LANES - 1) excl = carry;
#pragma unroll
  for (int c = 0; c < K; ++c) nxt[c] = fmaxf(v[c], excl) + sgv[c];
  return seg_at<LANES>(incl, 0);
}

// Accumulate position p's maxima over the columns of each lane.  fl =
// F[p][j0-1] (-1e30 at column 0); B0 and B1 hold -1e30 past bl.
template <int K, int KC>
__device__ __forceinline__ void score_cols(
    const float (&F)[KC], float fl, const float (&B0)[KC],
    const float (&B1)[KC], const float (&m)[4][KC], const float (&xg)[4],
    float& dmax, float (&imax)[4], float (&smax)[4]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float f = F[c];
    const float fp = c == 0 ? fl : F[c == 0 ? 0 : c - 1];
    dmax = fmaxf(dmax, f + B1[c]);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float sx = fmaxf(fp + m[x][c], f + xg[x]);
      imax[x] = fmaxf(imax[x], sx + B0[c]);
      smax[x] = fmaxf(smax[x], sx + B1[c]);
    }
  }
}

// F[p] -> F[p+1] on the columns of each lane.  mc = subs[cand[p],
// br[j-1]]; fl as in score_cols; carry = the prefix max of the columns
// left of this chunk.  Returns the prefix max through this chunk.
template <int K, int KC, int LANES = 16>
__device__ __forceinline__ float forward_cols(float (&F)[KC], float fl,
                                              const float (&gpv)[KC],
                                              const float (&mc)[KC],
                                              float vg, float carry, int l) {
  float v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float fp = c == 0 ? fl : F[c == 0 ? 0 : c - 1];
    v[c] = fmaxf(fp + mc[c], F[c] + vg) - gpv[c];
  }
#pragma unroll
  for (int c = 1; c < K; ++c) v[c] = fmaxf(v[c], v[c - 1]);
  float incl = v[K - 1];
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1)
    incl = fmaxf(incl, seg_up<LANES>(incl, off));
  incl = fmaxf(incl, carry);
  float excl = seg_up<LANES>(incl, 1);
  if (l == 0) excl = carry;
#pragma unroll
  for (int c = 0; c < K; ++c) F[c] = fmaxf(v[c], excl) + gpv[c];
  return seg_at<LANES>(incl, LANES - 1);
}

// Reduce each branch's 9 maxima over its lanes and store them at
// dst[0..8] (deletion, 4 insertions, 4 substitutions).  With 32 lanes a
// branch, the two halves fold first.  The 8 character maxima go through
// a transposed butterfly: at each step a lane keeps half of its values
// and trades the other half with its partner, so that after three steps
// lane l holds value l >> 1 and one more finishes it.
template <int LANES = 16>
__device__ __forceinline__ void reduce_maxima(float dmax, float (&imax)[4],
                                              float (&smax)[4], float* dst,
                                              int l, bool active) {
  if constexpr (LANES == 32) {
    dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, 16));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      imax[i] = fmaxf(imax[i], __shfl_xor_sync(kFull, imax[i], 16));
      smax[i] = fmaxf(smax[i], __shfl_xor_sync(kFull, smax[i], 16));
    }
    active = active && l < 16;
  }
  const bool h8 = l & 8, h4 = l & 4, h2 = l & 2;
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h8 ? imax[i] : smax[i];
    const float keep = h8 ? smax[i] : imax[i];
    u[i] = fmaxf(keep, __shfl_xor_sync(kFull, send, 8));
  }
  float t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h4 ? u[i] : u[i + 2];
    const float keep = h4 ? u[i + 2] : u[i];
    t[i] = fmaxf(keep, __shfl_xor_sync(kFull, send, 4));
  }
  const float send = h2 ? t[0] : t[1];
  const float keep = h2 ? t[1] : t[0];
  float s = fmaxf(keep, __shfl_xor_sync(kFull, send, 2));
  s = fmaxf(s, __shfl_xor_sync(kFull, s, 1));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, off));
  if (active) {
    if ((l & 1) == 0) dst[1 + ((l & 15) >> 1)] = s;
    if (l == 1) dst[0] = dmax;
  }
}

// After a block barrier: the weighted branch sums of positions pbase ..
// pbase+npos-1 from their maxima redb [npos][R][9], in branch order as
// the plain version (s_0*w_0 + s_1*w_1 + ..., no FMA contraction).
__device__ void flush_sums(const float* redb, const float* w_s,
                           const float* tot_s, int pbase, int npos, int b,
                           int Bg, int Cb, int R, float* total,
                           float* del_raw, float* ins4, float* sub4) {
  __syncthreads();
  for (int it = threadIdx.x; it < npos * 9; it += blockDim.x) {
    const int pp = it / 9;
    const int q = it - pp * 9;
    const int p = pbase + pp;
    if (p == Cb && (q == 0 || q >= 5)) continue;
    const float* s = redb + (size_t)pp * R * 9 + q;
    float acc = __fmul_rn(s[0], w_s[0]);
    for (int r2 = 1; r2 < R; ++r2)
      acc = __fadd_rn(acc, __fmul_rn(s[(size_t)r2 * 9], w_s[r2]));
    if (q == 0) {
      del_raw[(size_t)p * Bg + b] = acc;
    } else if (q <= 4) {
      ins4[((size_t)(q - 1) * (Cb + 1) + p) * Bg + b] = acc;
    } else {
      sub4[((size_t)(q - 5) * Cb + p) * Bg + b] = acc;
    }
  }
  if (pbase == 0 && threadIdx.x == 0) {  // sum_r w_r * B[0][r][0]
    float acc = __fmul_rn(tot_s[0], w_s[0]);
    for (int r2 = 1; r2 < R; ++r2)
      acc = __fadd_rn(acc, __fmul_rn(tot_s[r2], w_s[r2]));
    total[b] = acc;
  }
}

// The branch this thread works on (32 / LANES a warp): its index r (>= R:
// idle lanes), live width bl (-1 when idle) and the longest branch of its
// warp.
struct Branch {
  int l, r, bl, blmax;
  bool active;
  size_t lr;
};

template <int LANES = 16>
__device__ __forceinline__ Branch branch_of(const int32_t* blen, int b,
                                            int R, int S) {
  Branch x;
  x.l = threadIdx.x & (LANES - 1);
  x.r = threadIdx.x / LANES;
  x.active = x.r < R;
  x.lr = (size_t)b * R + (x.active ? x.r : 0);
  x.bl = -1;
  if (x.active) {
    const int v = blen[x.lr];
    x.bl = v < 0 ? 0 : (v > S ? S : v);
  }
  x.blmax = x.bl;
  if constexpr (LANES == 16)
    x.blmax = max(x.bl, __shfl_xor_sync(kFull, x.bl, 16));
  return x;
}

// Registers and spilled bytes per thread, the dynamic shared memory
// given and the resident blocks per SM of a kernel at `threads` a block,
// into out[0..3].  Returns a CUDA error code.
inline int kernel_info(const void* kern, size_t smem, int threads,
                       int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

}  // namespace
