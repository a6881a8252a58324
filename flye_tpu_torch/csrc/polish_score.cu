// K2 + K3: bubble-polish edit scoring, one thread block per group-lane
// (one bubble x one group of <= 8 branches; up to 32), two branches per
// warp, 16 lanes each.
//
// Replaces the Pallas kernels flye_tpu/ops/polish_pallas.py
// `_backward_kernel` (K2) and `_forward_score_kernel` (K3), both called
// from `_score_edits_pallas`.  The contract is that of ops/polish.py
// `_score_edits_raw`: total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg],
// sub4 [4, Cb, Bg], raw per-branch-weighted sums WITHOUT the per-lane
// masks, equal to the plain version bit for bit.
//
// Per branch, with bl = blen (columns 0..bl live) and cl = clen:
//   K2, rows i = cl-1 .. 0 (B[i] = sg for cl <= i <= Cb):
//     T[k]    = max(B[i+1][k+1] + subs[cand[i], br[k]], B[i+1][k] + vgap[i])
//               (the first term only for k < bl)
//     B[i][j] = max_{j<=k<=bl} (T[k] - sg[k]) + sg[j]
//   K3, positions p = 0 .. Cb, F[0] = gp:
//     SUBx[j]   = max(F[p][j-1] + subs[x, br[j-1]], F[p][j] + subs[x,4])
//                 (j = 0: F[p][0] + subs[x,4])
//     del[p]    = max_{j<=bl} F[p][j] + B[p+1][j]
//     ins4[x,p] = max_{j<=bl} SUBx[j] + B[p][j]
//     sub4[x,p] = max_{j<=bl} SUBx[j] + B[p+1][j]
//     F[p+1][j] = max_{k<=j} (U[k] - gp[k]) + gp[j], U[k] the SUBx
//                 recurrence with subs[cand[p], .] and vgap[p] as gap
//   then the branches' 0/1-weighted sums in branch order (multiply, then
//   add; never fused), as the plain version's _wsum.
// The gap tables (gp, sg) and candidate gap costs (vgap) come from the
// wrapper, computed with the plain version's tensor code.  Every max is
// exact in any order and every add is the plain version's, so the outputs
// are the plain version's bits.  Where a term does not exist (column 0's
// left neighbour, columns past bl) the kernels put -1e30 in its place:
// it loses every max against the finite scores.
//
// Live region.  Columns past bl never reach an output: past bl the
// suffix rows hold -1e30 (dropping out of every max) and the prefix rows
// only run rightwards.  K2 therefore computes and writes only rows
// i < cl, columns j <= bl, packed: bt is [Bg, R, Cb, S1p] f32 (S1p = S+1
// rounded up to 8) and branch (b, r) keeps row i at offset i * ldb of its
// Cb * S1p floats, ldb = bl+1 rounded up to 8.  A branch's live rows are
// then one run of whole 32-byte sectors (the columns bl < j < ldb hold
// junk): rows of S+1 floats at their natural stride left partial sectors
// at both ends of each row, and K2 wrote at a fifth of the memory rate.
// The rest of bt is left undefined.  K3 reads nothing else of it: it
// takes sg for the rows i >= cl.  Requires 0 <= blen.
//
// Layout of the work.  The raw path's branches are short (median 37
// live columns at its dominant bucket (Cb, S, R) = (64, 96, 8)), so a
// branch takes half a warp: lane t of its 16 holds the k contiguous
// columns t*k .. t*k+k-1, k = ceil((bl+1)/16) for the longer branch of
// the warp (k <= 4: up to 64 columns), with their gap costs and the 4
// match costs subs[x, br], loaded once per lane; the loops over a lane's
// columns are instantiated for each k.  A row is then a k-column max in
// each thread, one 4-step shuffle scan and one shuffle for the j+1 (K2)
// or j-1 (K3) neighbour.  Wider branches walk their live columns in
// chunks of 64 (4 per lane) with carries between chunks, the row kept in
// shared memory between rows ([R, ~S+1] f32 per block).  K3 keeps the
// suffix rows B[p+1] .. B[p+4] in flight while it scores position p
// (cp.async into a shared-memory ring, each lane its own columns).
//
// The row steps, the reduction of the maxima and the branch sums are
// device code shared with K4 (polish_rows.cuh).
//
// K3 reduces a branch's 9 maxima per position inside its half-warp (a
// transposed butterfly: 4 shuffles for the 8 character maxima, 4 for the
// deletion, both branches of the warp at once) and stores them in shared
// memory ([2][P][R][9] f32, P*R <= 512); every P positions one block
// barrier, and the block's threads form those positions' weighted sums in
// parallel.  Between barriers the warps run independently.
//
// What bounds it on an H100: instruction issue and the shuffle chains of
// the row scans.  K3 spends ~30 f32 instructions per live cell (the
// deletion term, the 4 edited rows reduced twice) and ~8 for the forward
// row, plus ~60 shuffle-and-select instructions per position and warp;
// K2 ~8 per cell plus ~20 per row and warp.  The live region of bt is
// written once and read once (~1.3 GB each way at (64, 96, 8) x 32768
// lanes, ~37 live columns of ~37 rows).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "polish_rows.cuh"

namespace {

constexpr int kLanes = 16;      // lanes per branch: two branches a warp
constexpr int kRedCells = 512;  // positions x branches per maxima buffer
constexpr int kAhead = 4;       // K3's suffix rows in flight per branch

// positions per K3 maxima buffer (one block barrier per P positions)
__host__ __device__ inline int red_positions(int R) {
  const int p = kRedCells / R;
  return p > 64 ? 64 : (p < 1 ? 1 : p);
}

// columns per lane held in registers: 2 up to S = 31, else 4
__host__ __device__ inline int lane_cols(int S) {
  return S + 1 <= 2 * kLanes ? 2 : 4;
}

// the shared-memory row of a branch, S+1 rounded up to whole chunks of
// kLanes * lane_cols(S) columns, where a branch may outgrow its registers
// (0 where it cannot)
__host__ __device__ inline int chunk_row_width(int S) {
  const int cw = kLanes * lane_cols(S);
  return S + 1 > cw ? (S + cw) / cw * cw : 0;
}

__host__ __device__ inline size_t rows_floats(int R, int S) {
  return (size_t)2 * ((R + 1) / 2) * chunk_row_width(S);
}

// Dynamic shared memory, f32 words first, then bytes:
//   K2: subs [32] | vgap [Cb] | rows [2 * warps][W] | cand [Cb] u8
//   K3: subs [32] | vgap [Cb] | w [R] | B[0][r][0] [R] |
//       maxima [2][P][R][9] | rows [2 * warps][W] | ring | cand [Cb] u8
__host__ __device__ inline size_t backward_smem(int Cb, int R, int S) {
  return (32 + (size_t)Cb + rows_floats(R, S)) * 4 + (size_t)Cb;
}

// K3's ring of suffix rows in flight: [warps][kAhead][columns per lane][32]
__host__ __device__ inline size_t ring_floats(int R, int S) {
  return (size_t)((R + 1) / 2) * kAhead * lane_cols(S) * 32;
}

__host__ __device__ inline size_t forward_smem(int Cb, int R, int S) {
  const size_t P = red_positions(R);
  return (32 + (size_t)Cb + 2 * (size_t)R + 18 * P * R + rows_floats(R, S) +
          ring_floats(R, S)) *
             4 +
         (size_t)Cb;
}

template <int KC, bool CHUNKED, int MAXW>
__global__ void __launch_bounds__(32 * MAXW, MAXW == 4 ? 10 : 1)
    polish_backward_kernel(const uint8_t* __restrict__ cand,
                           const uint8_t* __restrict__ br,
                           const int32_t* __restrict__ blen,
                           const float* __restrict__ sg,
                           const float* __restrict__ vgap,
                           const int32_t* __restrict__ clen,
                           const float* __restrict__ subs,
                           float* __restrict__ bt, int Cb, int R, int S) {
  constexpr int CW = kLanes * KC;  // columns per chunk
  extern __shared__ float smem[];
  const int W = CHUNKED ? chunk_row_width(S) : 0;
  float* sub_s = smem;
  float* vg_s = sub_s + 32;
  float* rows = vg_s + Cb;
  uint8_t* cand_s = (uint8_t*)(rows + rows_floats(R, S));
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < Cb; t += blockDim.x) {
    vg_s[t] = vgap[(size_t)b * Cb + t];
    cand_s[t] = cand[(size_t)b * Cb + t];
  }
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  __syncthreads();

  const int S1 = S + 1;
  const Branch x = branch_of(blen, b, R, S);
  const int l16 = x.l, bl = x.bl;
  int cl = clen[b];
  cl = cl < 0 ? 0 : (cl > Cb ? Cb : cl);
  const float* sgr = sg + x.lr * S1;
  const uint8_t* brr = br + x.lr * S;
  float* out = bt + x.lr * (size_t)Cb * sector_pad(S1);
  const int ldb = sector_pad(bl + 1);  // packed row stride (0 when idle)

  if (!CHUNKED || x.blmax < CW) {
    with_k<KC>((x.blmax + kLanes) / kLanes, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const int j0 = l16 * K;
      float nxt[KC], sgv[KC], m[4][KC];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int j = j0 + c;
        sgv[c] = j <= bl ? sgr[j] : 0.f;
        nxt[c] = sgv[c];  // B[cl] = sg
        const int bc = j < bl ? brr[j] : 0;
#pragma unroll
        for (int y = 0; y < 4; ++y) m[y][c] = sub_s[5 * y + bc];
      }
      for (int i = cl - 1; i >= 0; --i) {
        const int ci = cand_s[i];
        float mc[KC];
#pragma unroll
        for (int c = 0; c < K; ++c)
          mc[c] = ci == 0 ? m[0][c]
                          : ci == 1 ? m[1][c] : ci == 2 ? m[2][c] : m[3][c];
        const float right = seg_down(nxt[0], 1);
        backward_cols<K>(nxt, sgv, mc, j0, bl, vg_s[i], right, kNeg, l16);
        store_cols<K>(out + (size_t)i * ldb, j0, ldb, nxt);
      }
    });
  } else {
    float* row = rows + (size_t)x.r * W;
    for (int j = l16; j < W; j += kLanes) row[j] = j <= bl ? sgr[j] : 0.f;
    __syncwarp();  // each lane reads back its own chunk columns
    const int nch = (x.blmax + CW) / CW;  // live chunks
    for (int i = cl - 1; i >= 0; --i) {
      const float* subx = sub_s + 5 * cand_s[i];
      const float vg = vg_s[i];
      float* o = out + (size_t)i * ldb;
      float carry = kNeg, right_carry = 0.f;
      for (int ch = nch - 1; ch >= 0; --ch) {
        const int j0 = ch * CW + l16 * KC;
        float nxt[KC], sgv[KC], mc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = j0 + c;
          nxt[c] = row[j];
          sgv[c] = j <= bl ? sgr[j] : 0.f;
          mc[c] = subx[j < bl ? brr[j] : 0];
        }
        float right = seg_down(nxt[0], 1);
        if (l16 == kLanes - 1) right = right_carry;
        right_carry = seg_at(nxt[0], 0);
        carry = backward_cols<KC>(nxt, sgv, mc, j0, bl, vg, right, carry,
                                  l16);
#pragma unroll
        for (int c = 0; c < KC; ++c) row[j0 + c] = nxt[c];
        store_cols<KC>(o, j0, ldb, nxt);
      }
    }
  }
}

template <int KC, bool CHUNKED, int MAXW>
__global__ void __launch_bounds__(32 * MAXW, MAXW == 4 ? 4 : 1)
    polish_forward_score_kernel(
        const uint8_t* __restrict__ cand, const uint8_t* __restrict__ br,
        const int32_t* __restrict__ blen, const int32_t* __restrict__ clen,
        const float* __restrict__ gp, const float* __restrict__ sg,
        const float* __restrict__ bt, const float* __restrict__ vgap,
        const float* __restrict__ w, const float* __restrict__ subs,
        float* __restrict__ total, float* __restrict__ del_raw,
        float* __restrict__ ins4, float* __restrict__ sub4, int Bg, int Cb,
        int R, int S) {
  constexpr int CW = kLanes * KC;
  extern __shared__ float smem[];
  const int W = CHUNKED ? chunk_row_width(S) : 0;
  const int P = red_positions(R);
  float* sub_s = smem;
  float* vg_s = sub_s + 32;
  float* w_s = vg_s + Cb;
  float* tot_s = w_s + R;
  float* red = tot_s + R;
  float* rows = red + (size_t)18 * P * R;
  float* ring = rows + rows_floats(R, S);
  uint8_t* cand_s = (uint8_t*)(ring + ring_floats(R, S));
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < Cb; t += blockDim.x) {
    vg_s[t] = vgap[(size_t)b * Cb + t];
    cand_s[t] = cand[(size_t)b * Cb + t];
  }
  if (threadIdx.x < 25) sub_s[threadIdx.x] = subs[threadIdx.x];
  if (threadIdx.x < R) w_s[threadIdx.x] = w[(size_t)b * R + threadIdx.x];
  __syncthreads();

  const int S1 = S + 1;
  const Branch x = branch_of(blen, b, R, S);
  const int l16 = x.l, r = x.r, bl = x.bl;
  int cl = clen[b];
  cl = cl < 0 ? 0 : (cl > Cb ? Cb : cl);
  const float* gpr = gp + x.lr * S1;
  const float* sgr = sg + x.lr * S1;
  const uint8_t* brr = br + x.lr * S;
  const float* brow = bt + x.lr * (size_t)Cb * sector_pad(S1);
  const int ldb = sector_pad(bl + 1);
  // B[p]: K2's packed row below cl, sg from cl on
  auto brow_at = [&](int p) -> const float* {
    return p < cl ? brow + (size_t)p * ldb : sgr;
  };
  float xg[4];
#pragma unroll
  for (int y = 0; y < 4; ++y) xg[y] = sub_s[5 * y + 4];
  int buf = 0, pbase = 0;

  // the register path: k = ceil((blmax+1)/16) <= KC columns per lane;
  // each position runs the loops exactly k times, the block barrier stays
  // outside them.  Rows p+1 .. p+kAhead are in flight, each lane copying
  // its own columns into its slots of the ring (cp.async, then read back
  // by the same lane): ring[q % kAhead][c][lane] holds column j0+c of B[q].
  const bool in_regs = !CHUNKED || x.blmax < CW;
  const int k = (x.blmax + kLanes) / kLanes;
  const int j0 = l16 * k;
  const int lane = threadIdx.x & 31;
  float* my_ring = ring + (size_t)(threadIdx.x >> 5) * kAhead * KC * 32 + lane;
  float F[KC], gpv[KC], m[4][KC], B0[KC], B1[KC];
  auto fetch = [&](int q, auto kk) {  // one commit group per row
    if (q <= Cb) {
      const float* src = brow_at(q);
      float* d = my_ring + (size_t)(q % kAhead) * KC * 32;
#pragma unroll
      for (int c = 0; c < decltype(kk)::value; ++c)
        if (j0 + c <= bl) __pipeline_memcpy_async(d + c * 32, src + j0 + c, 4);
    }
    __pipeline_commit();
  };
  float* Fs = rows + (size_t)r * W;
  if (in_regs) {
    with_k<KC>(k, [&](auto kk) {
      const float* b0 = brow_at(0);
#pragma unroll
      for (int c = 0; c < decltype(kk)::value; ++c) {
        const int j = j0 + c;
        gpv[c] = j <= bl ? gpr[j] : 0.f;
        F[c] = gpv[c];  // F[0] = gp
        const int bc = (j >= 1 && j <= bl) ? brr[j - 1] : 0;
#pragma unroll
        for (int y = 0; y < 4; ++y) m[y][c] = sub_s[5 * y + bc];
        B0[c] = j <= bl ? b0[j] : kNeg;
        B1[c] = kNeg;
      }
      for (int q = 1; q <= kAhead; ++q) fetch(q, kk);
    });
  } else {
    for (int j = l16; j < W; j += kLanes) Fs[j] = j <= bl ? gpr[j] : 0.f;
    __syncwarp();
  }
  const int nch = (x.blmax + CW) / CW;  // live chunks (chunked path)
  for (int p = 0; p <= Cb; ++p) {
    const bool has1 = p < Cb;
    float* dst = red + ((size_t)(buf * P + p - pbase) * R + r) * 9;
    float dmax = kNeg, imax[4], smax[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) imax[y] = smax[y] = kNeg;
    if (in_regs) {
      with_k<KC>(k, [&](auto kk) {
        constexpr int K = decltype(kk)::value;
        __pipeline_wait_prior(kAhead - 1);  // B[p+1] has landed
        if (has1) {
          const float* d = my_ring + (size_t)((p + 1) % kAhead) * KC * 32;
#pragma unroll
          for (int c = 0; c < K; ++c) B1[c] = j0 + c <= bl ? d[c * 32] : kNeg;
        }
        float fl = seg_up(F[K - 1], 1);
        if (l16 == 0) fl = kNeg;
        score_cols<K>(F, fl, B0, B1, m, xg, dmax, imax, smax);
        if (p == 0 && l16 == 0 && x.active) tot_s[r] = B0[0];
        reduce_maxima(dmax, imax, smax, dst, l16, x.active);
        if (has1) {
          const int ci = cand_s[p];
          float mc[KC];
#pragma unroll
          for (int c = 0; c < K; ++c)
            mc[c] = ci == 0 ? m[0][c]
                            : ci == 1 ? m[1][c]
                                      : ci == 2 ? m[2][c] : m[3][c];
          forward_cols<K>(F, fl, gpv, mc, vg_s[p], kNeg, l16);
        }
        fetch(p + 1 + kAhead, kk);  // into the slot B[p+1] has left
#pragma unroll
        for (int c = 0; c < K; ++c) B0[c] = B1[c];
      });
    } else {
      const float* b0 = brow_at(p);
      const float* b1 = has1 ? brow_at(p + 1) : b0;
      const float* subx = sub_s + 5 * (has1 ? cand_s[p] : 0);
      const float vg = has1 ? vg_s[p] : 0.f;
      float fcarry = kNeg, vcarry = kNeg;
      for (int ch = 0; ch < nch; ++ch) {
        const int jc = ch * CW + l16 * KC;
        float Fc[KC], gc[KC], mm[4][KC], mc[KC], C0[KC], C1[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = jc + c;
          Fc[c] = Fs[j];
          gc[c] = j <= bl ? gpr[j] : 0.f;
          const int bc = (j >= 1 && j <= bl) ? brr[j - 1] : 0;
#pragma unroll
          for (int y = 0; y < 4; ++y) mm[y][c] = sub_s[5 * y + bc];
          mc[c] = subx[bc];
          C0[c] = j <= bl ? b0[j] : kNeg;
          C1[c] = j <= bl ? b1[j] : kNeg;
        }
        float fl = seg_up(Fc[KC - 1], 1);
        if (l16 == 0) fl = fcarry;
        fcarry = seg_at(Fc[KC - 1], kLanes - 1);
        score_cols<KC>(Fc, fl, C0, C1, mm, xg, dmax, imax, smax);
        if (p == 0 && ch == 0 && l16 == 0 && x.active) tot_s[r] = C0[0];
        if (has1) {
          vcarry = forward_cols<KC>(Fc, fl, gc, mc, vg, vcarry, l16);
#pragma unroll
          for (int c = 0; c < KC; ++c) Fs[jc + c] = Fc[c];
        }
      }
      reduce_maxima(dmax, imax, smax, dst, l16, x.active);
    }
    if (p - pbase == P - 1 || p == Cb) {
      flush_sums(red + (size_t)buf * P * R * 9, w_s, tot_s, pbase,
                 p - pbase + 1, b, Bg, Cb, R, total, del_raw, ins4, sub4);
      buf ^= 1;
      pbase = p + 1;
    }
  }
}

template <int KC, bool CHUNKED, int MAXW>
struct Cfg {
  static constexpr int kc = KC;
  static constexpr bool chunked = CHUNKED;
  static constexpr int maxw = MAXW;
};

// The instantiation for a bucket: columns per lane by S, chunks where a
// branch may outgrow them, block bound by R (two branches a warp).
template <typename Fn>
int dispatch(int R, int S, Fn&& fn) {
  const bool chunked = chunk_row_width(S) > 0;
  if (R <= 8) {
    if (lane_cols(S) == 2) return fn(Cfg<2, false, 4>());
    return chunked ? fn(Cfg<4, true, 4>()) : fn(Cfg<4, false, 4>());
  }
  if (lane_cols(S) == 2) return fn(Cfg<2, false, 16>());
  return chunked ? fn(Cfg<4, true, 16>()) : fn(Cfg<4, false, 16>());
}

inline int block_threads(int R) { return 32 * ((R + 1) / 2); }

}  // namespace

// Shapes (all contiguous, on one device):
//   cand u8 [Bg, Cb]; br u8 [Bg, R, S]; blen i32 [Bg, R] (>= 0);
//   clen i32 [Bg]; sg, gp f32 [Bg, R, S+1]; vgap f32 [Bg, Cb];
//   w f32 [Bg, R]; subs f32 [5, 5];
//   bt f32 [Bg, R, Cb, S1p], S1p = S+1 rounded up to 8: K2 writes rows
//     i < clen, columns j <= blen of each branch, row i at offset i * ldb
//     (ldb = blen+1 rounded up to 8) of the branch's Cb * S1p floats; K3
//     reads only those; the rest stays undefined;
//   total [Bg], del_raw [Cb, Bg], ins4 [4, Cb+1, Bg], sub4 [4, Cb, Bg].
// 1 <= R <= 32.  Each returns cudaGetLastError() after its launch.
extern "C" int polish_backward_launch(const void* cand, const void* br,
                                      const void* blen, const void* sg,
                                      const void* vgap, const void* clen,
                                      const void* subs, void* bt, int Bg,
                                      int Cb, int R, int S, void* stream) {
  if (Bg <= 0) return 0;
  return dispatch(R, S, [&](auto cfg) {
    using C = decltype(cfg);
    auto kern = polish_backward_kernel<C::kc, C::chunked, C::maxw>;
    const size_t smem = backward_smem(Cb, R, S);
    if (smem > 48 * 1024) {  // fails past the 227 KB a block may use
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<Bg, block_threads(R), smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
        (const float*)sg, (const float*)vgap, (const int32_t*)clen,
        (const float*)subs, (float*)bt, Cb, R, S);
    return (int)cudaGetLastError();
  });
}

extern "C" int polish_forward_score_launch(
    const void* cand, const void* br, const void* blen, const void* clen,
    const void* gp, const void* sg, const void* bt, const void* vgap,
    const void* w, const void* subs, void* total, void* del_raw, void* ins4,
    void* sub4, int Bg, int Cb, int R, int S, void* stream) {
  if (Bg <= 0) return 0;
  return dispatch(R, S, [&](auto cfg) {
    using C = decltype(cfg);
    auto kern = polish_forward_score_kernel<C::kc, C::chunked, C::maxw>;
    const size_t smem = forward_smem(Cb, R, S);
    if (smem > 48 * 1024) {  // fails past the 227 KB a block may use
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<Bg, block_threads(R), smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cand, (const uint8_t*)br, (const int32_t*)blen,
        (const int32_t*)clen, (const float*)gp, (const float*)sg,
        (const float*)bt, (const float*)vgap, (const float*)w,
        (const float*)subs, (float*)total, (float*)del_raw, (float*)ins4,
        (float*)sub4, Bg, Cb, R, S);
    return (int)cudaGetLastError();
  });
}

// The kernel instantiation a bucket takes (which = 2: K2, 3: K3):
// out[0..3] = registers per thread, spilled (local) bytes per thread,
// dynamic shared memory per block, resident blocks per SM.  Returns a
// CUDA error code.
extern "C" int polish_score_info(int which, int Cb, int R, int S, int* out) {
  return dispatch(R, S, [&](auto cfg) {
    using C = decltype(cfg);
    if (which == 2)
      return kernel_info(
          (const void*)polish_backward_kernel<C::kc, C::chunked, C::maxw>,
          backward_smem(Cb, R, S), block_threads(R), out);
    return kernel_info(
        (const void*)polish_forward_score_kernel<C::kc, C::chunked, C::maxw>,
        forward_smem(Cb, R, S), block_threads(R), out);
  });
}
