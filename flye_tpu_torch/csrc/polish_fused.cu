// K4: fused bubble-polish edit scoring, one thread block per group-lane
// (one bubble x one group of branches, up to 56), a branch on 16 lanes
// (two a warp; 32 lanes, one a warp, past 127 columns).
//
// Replaces the Pallas kernel flye_tpu/ops/polish_pallas.py
// `_fused_score_kernel` (called from `_score_edits_fused`, selected by
// FLYE_TPU_FUSED).  Its contract is that of K2+K3 (csrc/polish_score.cu)
// and of ops/polish.py `_score_edits_raw`:
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg],
// raw per-branch-weighted sums without the per-lane masks, equal to
// K2+K3's bit for bit: the rows, the maxima and the fixed-order, FMA-free
// branch sums are the same device code (polish_rows.cuh).
//
// One pass, nothing but the inputs and the four outputs in device memory.
// A branch's rows live in its lanes' registers over its live region only
// (columns 0..blen, rows below cand_len; k = ceil((blen+1)/lanes) columns
// a lane, the loops instantiated for k = 1-4, 6, 8).  The suffix rows B[i]
// that the scoring reads are kept in shared memory, each at the branch's
// live width (blen+1 rounded up to 8 floats, 16-byte stores and loads),
// each lane its own columns, so neither sweep needs a barrier.  Where the
// whole stack does not fit the block's pool (the worst case, (Cb+1) * R *
// (S+1) f32, is 201,760 B at (64, 96, 8)) it is checkpointed:
//   1. the backward sweep (K2's row step, i = cand_len-1 .. 0) keeps every
//      U-th row, B[0], B[U], B[2U], ...;
//   2. the forward sweep takes the positions in blocks [tU, tU+U): it first
//      recomputes B[tU+U-1] .. B[tU+1] from the checkpoint B[tU+U] (or
//      sg, from cand_len on) into a ring of U-1 rows, then scores the
//      block's positions against B[p] and B[p+1] as K3 does (prefix row F
//      in registers) and advances F.
// Each block takes the least U whose ceil(cand_len/U) + U-1 rows of its
// own live widths fit the pool: U = 1, no recomputation, for the paths'
// short branches.  The launch sizes the pool to the shared memory the
// SM can spare at the occupancy the registers allow, and at least to
// what the worst case needs at its best U (ops/polish.py `_fused_plan`:
// 15 rows at Cb = 64 instead of 65).  A branch's 9 maxima per position
// go to shared memory, and every P positions one block barrier lets the
// block form the weighted branch sums (K3's flush).
//
// What bounds it on an H100: instruction issue, as K3 (~30 f32
// instructions a live cell, K2's ~8 once, or twice where rows are
// recomputed, and the shuffle scans of the row steps), with no
// device-memory traffic beyond the inputs and outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polish_rows.cuh"

namespace {

// Dynamic shared memory, f32 words first, then bytes (ops/polish.py
// `_fused_plan` counts the same):
//   subs [32] | vgap [Cb] | w [R] | B[0][r][0] [R] | row offsets [R] |
//   row width, U [2] | maxima [2][P][R][9] | (16-byte aligned) the row
//   pool [pool] | cand [Cb] u8.
// The pool holds the block's rows: slot q < ceil(cand_len/U) is B[qU],
// slot ceil(cand_len/U) + u-1 the ring's B[tU+u]; a slot holds every
// branch's live columns, branch r at its offset, blen+1 rounded up to 8
// floats wide.  Each block takes the least U whose slots fit the pool.
__host__ __device__ inline size_t rows_offset(int Cb, int R, int P) {
  return ((size_t)34 + Cb + 3 * R + (size_t)18 * P * R + 3) & ~(size_t)3;
}

// the fewest row slots any U needs for Cb candidate rows:
// min over U of ceil(Cb/U) + U-1
__host__ __device__ inline int min_slots(int Cb) {
  int best = Cb;
  for (int U = 2; U <= Cb; ++U) {
    const int n = (Cb + U - 1) / U + U - 1;
    if (n < best) best = n;
  }
  return best;
}

// shared memory of a block whose pool holds `slots` rows of R branches
// of S+1 columns
__host__ __device__ inline size_t fused_smem(int Cb, int R, int S, int P,
                                             int slots) {
  return (rows_offset(Cb, R, P) + (size_t)slots * R * sector_pad(S + 1)) * 4 +
         Cb;
}

template <int KC, int LANES, int MAXW, int MINB>
__global__ void __launch_bounds__(32 * MAXW, MINB)
    polish_fused_kernel(const uint8_t* __restrict__ cand,
                        const uint8_t* __restrict__ br,
                        const int32_t* __restrict__ blen,
                        const float* __restrict__ sg,
                        const float* __restrict__ gp,
                        const float* __restrict__ vgap,
                        const int32_t* __restrict__ clen,
                        const float* __restrict__ w,
                        const float* __restrict__ subs,
                        float* __restrict__ total, float* __restrict__ del_raw,
                        float* __restrict__ ins4, float* __restrict__ sub4,
                        int Bg, int Cb, int R, int S, int P, int pool) {
  extern __shared__ float smem[];
  float* sub_s = smem;
  float* vg_s = sub_s + 32;
  float* w_s = vg_s + Cb;
  float* tot_s = w_s + R;
  int* off_s = reinterpret_cast<int*>(tot_s + R);  // [R], then W, U
  float* red = tot_s + 2 * R + 2;  // ends at rows_offset
  float* rows = smem + rows_offset(Cb, R, P);
  uint8_t* cand_s = (uint8_t*)(rows + pool);
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < Cb; t += blockDim.x) {
    vg_s[t] = vgap[(size_t)b * Cb + t];
    cand_s[t] = cand[(size_t)b * Cb + t];
  }
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  if (threadIdx.x < R) w_s[threadIdx.x] = w[(size_t)b * R + threadIdx.x];
  const int S1 = S + 1;
  const Branch x = branch_of<LANES>(blen, b, R, S);
  const int l = x.l, r = x.r, bl = x.bl;
  const int ldb = sector_pad(bl + 1);  // packed row width (0 when idle)
  if (l == 0 && x.active) off_s[r] = ldb;
  int cl = clen[b];
  cl = cl < 0 ? 0 : (cl > Cb ? Cb : cl);
  __syncthreads();
  if (threadIdx.x == 0) {  // row offsets, and the least U that fits
    int W = 0;
    for (int r2 = 0; r2 < R; ++r2) {
      const int v = off_s[r2];
      off_s[r2] = W;
      W += v;
    }
    int U = 1;
    while (U < cl && ((cl + U - 1) / U + U - 1) * W > pool) ++U;
    off_s[R] = W;
    off_s[R + 1] = U;
  }
  __syncthreads();
  const size_t slot_stride = off_s[R];
  const int U = off_s[R + 1];
  const int nck = (cl + U - 1) / U;
  const float* gpr = gp + x.lr * S1;
  const float* sgr = sg + x.lr * S1;
  const uint8_t* brr = br + x.lr * S;
  float* mine = rows + (x.active ? off_s[r] : 0);  // idle: never touched
  const int k = (x.blmax + LANES) / LANES;
  float xg[4];
#pragma unroll
  for (int y = 0; y < 4; ++y) xg[y] = sub_s[5 * y + 4];
  // per lane, its columns: sg, gp, subs[x, br[j-1]], F[p], B[p]
  float sgv[KC], gpv[KC], m[4][KC], F[KC], B0[KC];

  // the slot of checkpoint B[tU], and of the ring's B[tU+u] (0 < u < U)
  auto ckpt = [&](int t) { return mine + (size_t)t * slot_stride; };
  auto ring = [&](int u) { return mine + (size_t)(nck + u - 1) * slot_stride; };
  // B[i] into v (-1e30 past bl): sg from cand_len on, else the row at o
  auto load_row = [&](auto kk, int i, const float* o, float(&v)[KC]) {
    constexpr int K = decltype(kk)::value;
    const int j0 = l * K;
    if (i >= cl) {
#pragma unroll
      for (int c = 0; c < K; ++c) v[c] = j0 + c <= bl ? sgv[c] : kNeg;
    } else {
      load_cols<K>(o, j0, ldb, bl, v);
    }
  };
  // B[i+1] in nxt -> B[i]: K2's step; its match costs subs[cand[i],
  // br[j]] are the scoring's subs[x, br[j-1]] one column to the right
  auto row_down = [&](auto kk, int i, float(&nxt)[KC]) {
    constexpr int K = decltype(kk)::value;
    float mx[KC], mc[KC];
    pick_row<K>(cand_s[i], m, mx);
    const float next = seg_down<LANES>(mx[0], 1);
#pragma unroll
    for (int c = 0; c < K; ++c) mc[c] = c + 1 < K ? mx[c + 1 < K ? c + 1 : c] : next;
    const float right = seg_down<LANES>(nxt[0], 1);
    backward_cols<K, KC, LANES>(nxt, sgv, mc, l * K, bl, vg_s[i], right,
                                kNeg, l);
  };

  // ---- backward sweep: keep B[0], B[U], B[2U], ... ----
  with_k<KC>(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const int j0 = l * K;
    float nxt[KC];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int j = j0 + c;
      sgv[c] = j <= bl ? sgr[j] : 0.f;
      gpv[c] = j <= bl ? gpr[j] : 0.f;
      F[c] = gpv[c];    // F[0] = gp
      nxt[c] = sgv[c];  // B[cl] = sg
      const int bc = (j >= 1 && j <= bl) ? brr[j - 1] : 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) m[y][c] = sub_s[5 * y + bc];
    }
    int t = (cl - 1) / U, u = cl - 1 - t * U;  // row i = tU + u
    for (int i = cl - 1; i >= 0; --i) {
      row_down(kk, i, nxt);
      if (u == 0) {
        store_cols<K>(ckpt(t), j0, ldb, nxt);
        --t;
        u = U;
      }
      --u;
    }
    load_row(kk, 0, ckpt(0), B0);
  });

  // ---- forward sweep, U positions a block ----
  int buf = 0, pbase = 0;
  for (int lo = 0, t = 0; lo <= Cb; lo += U, ++t) {
    const int top = min(lo + U, cl);  // B[top]: a checkpoint or sg
    if (top - 1 > lo) {
      with_k<KC>(k, [&](auto kk) {  // B[top-1] .. B[lo+1] into the ring
        constexpr int K = decltype(kk)::value;
        float nxt[KC];
        load_row(kk, top, ckpt(t + 1), nxt);
        for (int i = top - 1; i > lo; --i) {
          row_down(kk, i, nxt);
          store_cols<K>(ring(i - lo), l * K, ldb, nxt);
        }
      });
    }
    const int hi = min(lo + U - 1, Cb);
    for (int p = lo; p <= hi; ++p) {
      const bool has1 = p < Cb;
      float* dst = red + ((size_t)(buf * P + p - pbase) * R + r) * 9;
      with_k<KC>(k, [&](auto kk) {
        constexpr int K = decltype(kk)::value;
        float B1[KC];
        if (has1) {
          load_row(kk, p + 1, p + 1 - lo == U ? ckpt(t + 1) : ring(p + 1 - lo),
                   B1);
        } else {
#pragma unroll
          for (int c = 0; c < K; ++c) B1[c] = B0[c];
        }
        float dmax = kNeg, imax[4], smax[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) imax[y] = smax[y] = kNeg;
        float fl = seg_up<LANES>(F[K - 1], 1);
        if (l == 0) fl = kNeg;
        score_cols<K>(F, fl, B0, B1, m, xg, dmax, imax, smax);
        if (p == 0 && l == 0 && x.active) tot_s[r] = B0[0];
        reduce_maxima<LANES>(dmax, imax, smax, dst, l, x.active);
        if (has1) {
          float mc[KC];
          pick_row<K>(cand_s[p], m, mc);
          forward_cols<K, KC, LANES>(F, fl, gpv, mc, vg_s[p], kNeg, l);
        }
#pragma unroll
        for (int c = 0; c < K; ++c) B0[c] = B1[c];
      });
      if (p - pbase == P - 1 || p == Cb) {
        flush_sums(red + (size_t)buf * P * R * 9, w_s, tot_s, pbase,
                   p - pbase + 1, b, Bg, Cb, R, total, del_raw, ins4, sub4);
        buf ^= 1;
        pbase = p + 1;
      }
    }
  }
}

template <int KC, int LANES, int MAXW, int MINB>
struct Cfg {
  static constexpr int kc = KC;
  static constexpr int lanes = LANES;
  static constexpr int maxw = MAXW;
  static constexpr int minb = MINB;
};

// The instantiation for a bucket: columns per lane and lanes per branch by
// S, the block bound by R.  Returns cudaErrorInvalidValue where none
// takes it; every bucket ops/polish.py `fits_fused` admits has one.
template <typename Fn>
int dispatch(int R, int S, Fn&& fn) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  if (S + 1 <= 32) {
    if (R <= 8) return fn(Cfg<2, 16, 4, 4>());
    if (R <= 32) return fn(Cfg<2, 16, 16, 1>());
    if (R <= 56) return fn(Cfg<2, 16, 28, 1>());
  } else if (S + 1 <= 64) {
    if (R <= 8) return fn(Cfg<4, 16, 4, 4>());
    if (R <= 32) return fn(Cfg<4, 16, 16, 1>());
    if (R <= 56) return fn(Cfg<4, 16, 28, 1>());
  } else if (S + 1 <= 128) {
    if (R <= 8) return fn(Cfg<8, 16, 4, 4>());
    if (R <= 32) return fn(Cfg<8, 16, 16, 1>());
  } else if (S + 1 <= 256) {
    if (R <= 8) return fn(Cfg<8, 32, 8, 2>());
  }
  return (int)cudaErrorInvalidValue;
}

template <typename C>
int block_threads(int R) {
  return C::lanes == 16 ? 32 * ((R + 1) / 2) : 32 * R;
}

// A block's dynamic shared memory: as much as the blocks its registers
// let an SM hold can share (H100: 65,536 registers, 233,472 B with 1,024
// reserved a block, 227 KB at most a block), within the least the worst
// case needs and the whole stack (U = 1 for any lengths).  0 where even
// the least does not fit.
template <typename C>
size_t block_smem(const void* kern, int Cb, int R, int S, int P) {
  const size_t least = fused_smem(Cb, R, S, P, min_slots(Cb));
  if (least > 232448) return 0;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kern) != cudaSuccess) return least;
  const int warps = block_threads<C>(R) / 32;
  const int per_warp = (a.numRegs * 32 + 255) / 256 * 256;
  int blocks = 65536 / (per_warp * warps);
  blocks = blocks < 1 ? 1 : blocks;
  if (blocks > 64 / warps) blocks = 64 / warps;
  size_t target = 233472 / blocks - 1024;
  if (target > 232448) target = 232448;
  const size_t full = fused_smem(Cb, R, S, P, Cb);
  size_t smem = full < target ? full : target;
  return smem > least ? smem : least;
}

}  // namespace

// Shapes (all contiguous, on one device):
//   cand u8 [Bg, Cb]; br u8 [Bg, R, S]; blen i32 [Bg, R] (>= 0);
//   sg, gp f32 [Bg, R, S+1]; vgap f32 [Bg, Cb]; clen i32 [Bg];
//   w f32 [Bg, R]; subs f32 [5, 5];
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg].
// P: positions per maxima buffer (ops/polish.py `_fused_plan`).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue where no
// instantiation takes (R, S) or its least shared memory exceeds a block's.
extern "C" int polish_fused_launch(const void* cand, const void* br,
                                   const void* blen, const void* sg,
                                   const void* gp, const void* vgap,
                                   const void* clen, const void* w,
                                   const void* subs, void* total,
                                   void* del_raw, void* ins4, void* sub4,
                                   int Bg, int Cb, int R, int S, int P,
                                   void* stream) {
  if (Bg <= 0) return 0;
  if (P < 1 || Cb < 0) return (int)cudaErrorInvalidValue;
  return dispatch(R, S, [&](auto cfg) {
    using C = decltype(cfg);
    auto kern = polish_fused_kernel<C::kc, C::lanes, C::maxw, C::minb>;
    const size_t smem = block_smem<C>((const void*)kern, Cb, R, S, P);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int pool = (int)((smem - Cb) / 4 - rows_offset(Cb, R, P));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<Bg, block_threads<C>(R), smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
        (const float*)sg, (const float*)gp, (const float*)vgap,
        (const int32_t*)clen, (const float*)w, (const float*)subs,
        (float*)total, (float*)del_raw, (float*)ins4, (float*)sub4, Bg, Cb,
        R, S, P, pool);
    return (int)cudaGetLastError();
  });
}

// The instantiation a bucket takes: out[0..3] = registers per thread,
// spilled (local) bytes per thread, dynamic shared memory per block (as
// the launch sizes it), resident blocks per SM.  Returns a CUDA error
// code.
extern "C" int polish_fused_info(int Cb, int R, int S, int P, int* out) {
  return dispatch(R, S, [&](auto cfg) {
    using C = decltype(cfg);
    const void* kern =
        (const void*)polish_fused_kernel<C::kc, C::lanes, C::maxw, C::minb>;
    const size_t smem = block_smem<C>(kern, Cb, R, S, P);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    return kernel_info(kern, smem, block_threads<C>(R), out);
  });
}
