// K2 + K3: bubble-polish edit scoring, one thread block per group-lane
// (one bubble x one group of <= 8 branches), one warp per branch.
//
// Replaces the Pallas kernels flye_tpu/ops/polish_pallas.py
// `_backward_kernel` (K2) and `_forward_score_kernel` (K3), both called
// from `_score_edits_pallas`.  The contract is that of
// `score_edits_pallas_raw` / ops/polish.py `_score_edits_raw_jnp`:
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg],
// raw per-branch-weighted sums WITHOUT the per-lane masks (those and the
// char argmax follow the branch-group reduction, in _finish_scores).
//
// K2 walks candidate rows i = Cb-1 .. 0 and writes every suffix row
// B[i] ([R, S+1] per lane) to device memory; B[Cb] is the gap row sg:
//   diag[j] = B[i+1][j+1] + subs[cand[i], branch[j]]   (j < blen)
//   tmp[j]  = max(diag[j], B[i+1][j] + vgap[i]), NEG past blen
//   B[i][j] = suffixmax_j(tmp - sg) + sg;  sg on rows i >= clen;
//             ds[i] on columns j > blen.
// K3 walks positions p = 0 .. Cb, carries the prefix row F[p] in shared
// memory, reads B[p] and B[p+1] once each from device memory, and
// reduces per branch
//   del[p]    = max_{j<=blen} F[p][j] + B[p+1][j]
//   ins4[x,p] = max_{j<=blen} SUBx[j] + B[p][j]
//   sub4[x,p] = max_{j<=blen} SUBx[j] + B[p+1][j]
//   SUBx[j]   = max(F[p][j-1] + subs[x, branch[j-1]], F[p][j] + subs[x,4])
// then sums the branches in a fixed order (no atomics: results are the
// same launch to launch) with their 0/1 weights.
//
// Match costs come straight from the 5x5 table (subs[cand, branch]);
// the TPU kernels' one-hot planes and 128-lane branch packing do not
// carry over.  The gap prefix/suffix tables (gp, sg), the candidate gap
// costs (vgap) and the suffix deletion costs (ds) are computed by the
// wrapper with the same tensor code as the plain version, so the kernels'
// rows are bit-identical to the plain version's; only the per-lane
// branch sum may round differently from a reordered reduction.
//
// What bounds it on an H100: the in-row scans.  Every row is a serial
// walk over S+1 columns in 32-column tiles with a 5-step shuffle scan
// each, and rows depend on one another, so a lane is latency-bound; the
// card fills only through many lanes (Bg blocks).  K3 also streams the
// B tensor ([Bg, Cb+1, R, S+1] f32, ~1.6 GB at the (64, 96) bucket with
// 8192 lanes) from device memory, twice per row.
//
// Shared memory: two rows per branch (double buffer) = 2*R*(S+1)*4 B,
// 147 KB at the largest bucket (S = 2304, R = 8), plus the 5x5 table and
// K3's [R, 9] reduction scratch.  The B rows (another 74 KB each) do not
// fit beside them at that bucket, so K3 streams B from device memory at
// every size; the gap tables and branch codes are read from device
// memory too (they stay hot in L1/L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void polish_backward_kernel(
    const uint8_t* __restrict__ cand, const uint8_t* __restrict__ br,
    const int32_t* __restrict__ blen, const float* __restrict__ sg,
    const float* __restrict__ vgap, const float* __restrict__ ds,
    const int32_t* __restrict__ clen, const float* __restrict__ subs,
    float* __restrict__ bt, int Cb, int R, int S) {
  extern __shared__ float smem[];
  __shared__ float sub_s[25];
  const int b = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S1 = S + 1;
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  __syncthreads();

  float* nxt = smem + (size_t)r * S1;
  float* cur = smem + (size_t)(R + r) * S1;
  const float* sgr = sg + ((size_t)b * R + r) * S1;
  const uint8_t* brr = br + ((size_t)b * R + r) * S;
  int bl = blen[(size_t)b * R + r];
  bl = bl > S ? S : bl;
  const int cl = clen[b];
  const size_t rowstride = (size_t)R * S1;
  float* out = bt + (size_t)b * (Cb + 1) * rowstride + (size_t)r * S1;

  for (int j = lane; j < S1; j += 32) {  // B[Cb] = sg
    const float v = sgr[j];
    nxt[j] = v;
    out[(size_t)Cb * rowstride + j] = v;
  }
  __syncwarp();
  const int ntiles = (S1 + 31) / 32;
  for (int i = Cb - 1; i >= 0; --i) {
    const float* subx = sub_s + 5 * cand[(size_t)b * Cb + i];
    const float vg = vgap[(size_t)b * Cb + i];
    const float dsi = ds[(size_t)b * (Cb + 1) + i];
    float carry = kNeg;
    for (int t = ntiles - 1; t >= 0; --t) {
      const int j = t * 32 + lane;
      float v = kNeg, sgj = 0.f;
      if (j < S1) {
        sgj = sgr[j];
        float tmp;
        if (j < S) {
          const float diag = j < bl ? nxt[j + 1] + subx[brr[j]] : kNeg;
          tmp = fmaxf(diag, nxt[j] + vg);
        } else {
          tmp = nxt[j] + vg;
        }
        if (j > bl) tmp = kNeg;
        v = tmp - sgj;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {  // suffix max in the tile
        const float o = __shfl_down_sync(kFull, v, off);
        if (lane + off < 32) v = fmaxf(v, o);
      }
      v = fmaxf(v, carry);
      carry = __shfl_sync(kFull, v, 0);
      if (j < S1) {
        float row = v + sgj;
        if (i >= cl) row = sgj;
        if (j > bl) row = dsi;
        cur[j] = row;
        out[(size_t)i * rowstride + j] = row;
      }
    }
    __syncwarp();
    float* tmpp = nxt;
    nxt = cur;
    cur = tmpp;
  }
}

__global__ void polish_forward_score_kernel(
    const uint8_t* __restrict__ cand, const uint8_t* __restrict__ br,
    const int32_t* __restrict__ blen, const float* __restrict__ gp,
    const float* __restrict__ bt, const float* __restrict__ vgap,
    const float* __restrict__ w, const float* __restrict__ subs,
    float* __restrict__ total, float* __restrict__ del_raw,
    float* __restrict__ ins4, float* __restrict__ sub4, int Bg, int Cb,
    int R, int S) {
  extern __shared__ float smem[];
  __shared__ float sub_s[25];
  const int b = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S1 = S + 1;
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  __syncthreads();

  float* F = smem + (size_t)r * S1;
  float* Fn = smem + (size_t)(R + r) * S1;
  float* red = smem + (size_t)2 * R * S1;  // [R, 9] per-branch maxima
  const float* gpr = gp + ((size_t)b * R + r) * S1;
  const uint8_t* brr = br + ((size_t)b * R + r) * S;
  int bl = blen[(size_t)b * R + r];
  bl = bl > S ? S : bl;
  const size_t rowstride = (size_t)R * S1;
  const float* bb = bt + (size_t)b * (Cb + 1) * rowstride;
  const float* brow = bb + (size_t)r * S1;
  float xg[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) xg[x] = sub_s[5 * x + 4];

  for (int j = lane; j < S1; j += 32) F[j] = gpr[j];  // F[0] = gp
  __syncwarp();
  const int ntiles = (S1 + 31) / 32;
  for (int p = 0; p <= Cb; ++p) {
    const bool has1 = p < Cb;
    const float* B0 = brow + (size_t)p * rowstride;
    const float* B1 = B0 + rowstride;
    float dmax = kNeg, imax[4], smax[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) imax[x] = smax[x] = kNeg;
    for (int j = lane; j <= bl; j += 32) {
      const float f = F[j];
      const float b0 = B0[j];
      const float b1 = has1 ? B1[j] : 0.f;
      if (has1) dmax = fmaxf(dmax, f + b1);
      const float fp = j > 0 ? F[j - 1] : 0.f;
      const int bc = j > 0 ? brr[j - 1] : 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float sx = j == 0 ? f + xg[x]
                                : fmaxf(fp + sub_s[5 * x + bc], f + xg[x]);
        imax[x] = fmaxf(imax[x], sx + b0);
        if (has1) smax[x] = fmaxf(smax[x], sx + b1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, off));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        imax[x] = fmaxf(imax[x], __shfl_xor_sync(kFull, imax[x], off));
        smax[x] = fmaxf(smax[x], __shfl_xor_sync(kFull, smax[x], off));
      }
    }
    if (lane == 0) {
      red[r * 9] = dmax;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        red[r * 9 + 1 + x] = imax[x];
        red[r * 9 + 5 + x] = smax[x];
      }
    }
    __syncthreads();
    const int q = threadIdx.x;
    if (q < 9 && (has1 || (q >= 1 && q <= 4))) {
      // weighted branch sum in a fixed order; no FMA contraction
      float acc = 0.f;
      for (int r2 = 0; r2 < R; ++r2)
        acc = __fadd_rn(acc, __fmul_rn(w[(size_t)b * R + r2],
                                       red[r2 * 9 + q]));
      if (q == 0) {
        del_raw[(size_t)p * Bg + b] = acc;
      } else if (q <= 4) {
        ins4[((size_t)(q - 1) * (Cb + 1) + p) * Bg + b] = acc;
      } else {
        sub4[((size_t)(q - 5) * Cb + p) * Bg + b] = acc;
      }
    }
    if (p == 0 && q == 9) {  // current score: sum_r w_r * B[0][r][0]
      float acc = 0.f;
      for (int r2 = 0; r2 < R; ++r2)
        acc = __fadd_rn(acc, __fmul_rn(w[(size_t)b * R + r2],
                                       bb[(size_t)r2 * S1]));
      total[b] = acc;
    }
    if (has1) {  // F[p] -> F[p+1]
      const float* subx = sub_s + 5 * cand[(size_t)b * Cb + p];
      const float vg = vgap[(size_t)b * Cb + p];
      float carry = kNeg;
      for (int t = 0; t < ntiles; ++t) {
        const int j = t * 32 + lane;
        float v = kNeg, gpj = 0.f;
        if (j < S1) {
          gpj = gpr[j];
          const float tmp =
              j == 0 ? F[0] + vg
                     : fmaxf(F[j - 1] + subx[brr[j - 1]], F[j] + vg);
          v = tmp - gpj;
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {  // prefix max in tile
          const float o = __shfl_up_sync(kFull, v, off);
          if (lane >= off) v = fmaxf(v, o);
        }
        v = fmaxf(v, carry);
        carry = __shfl_sync(kFull, v, 31);
        if (j < S1) Fn[j] = v + gpj;
      }
      __syncwarp();
      float* tmpp = F;
      F = Fn;
      Fn = tmpp;
    }
    __syncthreads();  // red[] is rewritten at the next position
  }
}

}  // namespace

// Shapes (all contiguous, on one device):
//   cand u8 [Bg, Cb]; br u8 [Bg, R, S]; blen i32 [Bg, R];
//   sg, gp f32 [Bg, R, S+1]; vgap f32 [Bg, Cb]; ds f32 [Bg, Cb+1];
//   clen i32 [Bg]; w f32 [Bg, R]; subs f32 [5, 5];
//   bt f32 [Bg, Cb+1, R, S+1] (K2 output, K3 input);
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg].
// 1 <= R <= 32.  Each returns cudaGetLastError() after its launch.
extern "C" int polish_backward_launch(const void* cand, const void* br,
                                      const void* blen, const void* sg,
                                      const void* vgap, const void* ds,
                                      const void* clen, const void* subs,
                                      void* bt, int Bg, int Cb, int R,
                                      int S, void* stream) {
  if (Bg <= 0) return 0;
  const size_t smem = (size_t)2 * R * (S + 1) * sizeof(float);
  cudaFuncSetAttribute(polish_backward_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  polish_backward_kernel<<<Bg, 32 * R, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
      (const float*)sg, (const float*)vgap, (const float*)ds,
      (const int32_t*)clen, (const float*)subs, (float*)bt, Cb, R, S);
  return (int)cudaGetLastError();
}

extern "C" int polish_forward_score_launch(
    const void* cand, const void* br, const void* blen, const void* gp,
    const void* bt, const void* vgap, const void* w, const void* subs,
    void* total, void* del_raw, void* ins4, void* sub4, int Bg, int Cb,
    int R, int S, void* stream) {
  if (Bg <= 0) return 0;
  const size_t smem = ((size_t)2 * R * (S + 1) + (size_t)9 * R) *
                      sizeof(float);
  cudaFuncSetAttribute(polish_forward_score_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  polish_forward_score_kernel<<<Bg, 32 * R, smem,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
      (const float*)gp, (const float*)bt, (const float*)vgap,
      (const float*)w, (const float*)subs, (float*)total,
      (float*)del_raw, (float*)ins4, (float*)sub4, Bg, Cb, R, S);
  return (int)cudaGetLastError();
}
