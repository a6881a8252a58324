// K4: fused bubble-polish edit scoring, one thread block per group-lane
// (one bubble x one group of <= 8 branches), one warp per branch.
//
// Replaces the Pallas kernel flye_tpu/ops/polish_pallas.py
// `_fused_score_kernel` (called from `_score_edits_fused`, selected by
// FLYE_TPU_FUSED).  Its contract is that of K2+K3 (csrc/polish_score.cu)
// and of ops/polish.py `_score_edits_raw`:
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg],
// raw per-branch-weighted sums without the per-lane masks.
//
// One pass: the backward sweep (K2's arithmetic) writes every suffix row
// B[i] ([R, S+1] per lane) into a shared-memory stack [Cb+1][R][S+1]
// instead of device memory; after a barrier the forward sweep (K3's
// arithmetic) carries the prefix row F[p] in shared memory and reads
// B[p] and B[p+1] from the stack.  Only the four outputs touch device
// memory besides the inputs.  The rows, the per-branch maxima and the
// fixed-order, FMA-free branch sums are computed exactly as in K2 and K3,
// so the outputs equal K2+K3's bit for bit.
//
// What bounds it on an H100: the same row latency chain as K2 and K3
// (each row a serial walk over S+1 columns in 32-column tiles with a
// 5-step shuffle scan, rows dependent on one another), now with both
// sweeps in one block.  The stack takes (Cb+1)*R*(S+1)*4 B: 201,760 B at
// the dominant bucket (Cb, S, R) = (64, 96, 8), so only one block fits on
// an SM (8 warps) where K2 and K3 hold about eight.  The design trades
// that occupancy for the B-row round trip through device memory; the
// wrapper only takes buckets whose stack fits the 232,448 B a block may
// use (ops/polish.py `fits_fused`), and K2+K3 run the rest.
//
// Not carried over from the TPU kernel: the VMEM model, U-row blocking,
// 128-lane branch packing and the masked column writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void polish_fused_kernel(
    const uint8_t* __restrict__ cand, const uint8_t* __restrict__ br,
    const int32_t* __restrict__ blen, const float* __restrict__ sg,
    const float* __restrict__ gp, const float* __restrict__ vgap,
    const float* __restrict__ ds, const int32_t* __restrict__ clen,
    const float* __restrict__ w, const float* __restrict__ subs,
    float* __restrict__ total, float* __restrict__ del_raw,
    float* __restrict__ ins4, float* __restrict__ sub4, int Bg, int Cb,
    int R, int S) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S1 = S + 1;
  const size_t rowstride = (size_t)R * S1;
  // layout: stack [Cb+1][R][S1] | F [R][S1] | Fn [R][S1] | red [R][9] |
  // the 5x5 table (ops/polish.py _fused_smem_bytes counts the same)
  float* stack = smem;
  float* F = stack + (size_t)(Cb + 1) * rowstride + (size_t)r * S1;
  float* Fn = F + rowstride;
  float* red = stack + (size_t)(Cb + 3) * rowstride;
  float* sub_s = red + 9 * R;
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  __syncthreads();

  const float* sgr = sg + ((size_t)b * R + r) * S1;
  const float* gpr = gp + ((size_t)b * R + r) * S1;
  const uint8_t* brr = br + ((size_t)b * R + r) * S;
  int bl = blen[(size_t)b * R + r];
  bl = bl > S ? S : bl;
  const int cl = clen[b];
  float* brow = stack + (size_t)r * S1;  // B[i] of this branch at i*rowstride
  const int ntiles = (S1 + 31) / 32;

  // ---- backward sweep (K2): B[Cb] = sg, then i = Cb-1 .. 0 ----
  for (int j = lane; j < S1; j += 32) brow[(size_t)Cb * rowstride + j] = sgr[j];
  __syncwarp();
  for (int i = Cb - 1; i >= 0; --i) {
    const float* nxt = brow + (size_t)(i + 1) * rowstride;
    float* cur = brow + (size_t)i * rowstride;
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
      }
    }
    __syncwarp();
  }
  __syncthreads();  // the current score below reads every branch's B[0]

  // ---- forward sweep + scoring (K3), B rows from the stack ----
  float xg[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) xg[x] = sub_s[5 * x + 4];
  for (int j = lane; j < S1; j += 32) F[j] = gpr[j];  // F[0] = gp
  __syncwarp();
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
                                       stack[(size_t)r2 * S1]));
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
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg].
// 1 <= R <= 32; smem_bytes is the block's dynamic shared memory, from
// ops/polish.py `_fused_smem_bytes(Cb, R, S)`.  Returns cudaGetLastError()
// after the launch (a block that asks for more shared memory than the
// card allows is refused there).
extern "C" int polish_fused_launch(const void* cand, const void* br,
                                   const void* blen, const void* sg,
                                   const void* gp, const void* vgap,
                                   const void* ds, const void* clen,
                                   const void* w, const void* subs,
                                   void* total, void* del_raw, void* ins4,
                                   void* sub4, int Bg, int Cb, int R, int S,
                                   int smem_bytes, void* stream) {
  if (Bg <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      polish_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  polish_fused_kernel<<<Bg, 32 * R, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
      (const float*)sg, (const float*)gp, (const float*)vgap,
      (const float*)ds, (const int32_t*)clen, (const float*)w,
      (const float*)subs, (float*)total, (float*)del_raw, (float*)ins4,
      (float*)sub4, Bg, Cb, R, S);
  return (int)cudaGetLastError();
}
