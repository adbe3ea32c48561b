// B4 and B5: the encoder's block 0 in training, forward and backward, with
// the full-rate activation kept on the SM in both directions.
//
// Replaces voicemap_tpu/ops/pallas_conv_train.py :: _fwd_kernel (B4, wrapper
// pallas_fwd_core) and _bwd_kernel (B5, wrapper pallas_bwd_core). For row b,
// pooled position p, phase j = 0..3 and channel c, both recompute
//   a_j = relu( sum_k x[4p + j + k - 15] * w[k, c]  +  bias[c] )
// (x = 0 outside [0, T)), with x and w rounded to the GEMM dtype, the taps
// summed in f32 and the bias added after, in f32.
//
// B4 writes a_sel[b, p, c] = s * max_j(s * a_j), s = sign(gamma[c]) (the
// value BatchNorm's monotone affine makes the max-pool pick), rounded once
// to the selection dtype, and the per-channel sums (sum a, sum a^2,
// #(a > 0)) over every full-rate position.
// B5 routes the pooled cotangent g[b, p, c] (f32, rounded to the GEMM dtype
// in registers) to the first phase in time order with s * a_j equal to the
// max, forms dz_j = a_j > 0 ? (c0*g_j + c1) + c2*a_j : 0 in f32 op by op,
// sums dz_j into db in f32, rounds dz_j to the GEMM dtype and accumulates
// dW[k, c] += x[4p + j + k - 15] * dz_j.
//
// block0_train_tc, the route of every bf16 GEMM (the train step in bf16):
// B2's main loop (block0_mma.cuh), mma.sync m16n8k16 bf16 -> f32 in the
// direct form, with a position's four phases in one thread's accumulators,
// so the epilogue runs in registers, one n8 tile at a time right after that
// tile's four products (the tensor cores take the next tile while the
// thread works on this one):
// - B4: + bias, relu, the statistics over the thread's phases (positions
//   past the row's end masked), the select s * max_j(s * a_j) (the max where
//   s > 0, the min where not: the same value exactly), rounded once into the
//   staged output tile, stored in 16-byte vectors;
// - B5: the same products through the same functions, so its a_j are B4's
//   bit for bit and it routes to the phase B4 selected; dz in f32, db in
//   registers, dz rounded to bf16, then the weight gradient as a second
//   mma: dW (32 taps x the warp's 32 channels) += X (taps x 32 full-rate
//   positions) · dZ (positions x channels), K = the unit's 32 positions in
//   the order (phase 2s: positions 0..7, phase 2s + 1: 0..7) for k16 step
//   s. dZ's B fragment is the accumulator's dz transposed in registers:
//   for one n8 tile and one phase the thread holds dz of its position g
//   and channels 2tq, 2tq + 1, an 8x8 matrix in movmatrix's layout, which
//   .trans turns into channel g's dz at positions 2tq, 2tq + 1, the B
//   fragment's pair. X's A fragment pairs x at positions 2tq and 2tq + 1 of
//   one phase, samples 4 apart: the window is staged a third time as x4[i]
//   = (x[i], x[i + 4]) in bf16, so each register is one 32-bit load. The
//   next item's g rows are prefetched into L2 while this item runs.
// - The grid is a fixed function of the shape (ops/block0_train_tc.grid):
//   a CTA keeps one group of up to 128 channels (4 slices) for its life and
//   walks (row, tile) items of that group; each warp keeps one slice and a
//   fixed share of a tile's 8-position groups, so its statistics (B4) or
//   its dW and db (B5) stay in registers across all its items. At the end
//   the 8 lanes of a channel fold by shuffles, the warps of a slice in
//   shared memory in warp order, into one partial row per CTA, and
//   fold.cuh folds the rows in a fixed order: no atomics, the sums repeat
//   run to run.
// What bounds them on the H100: bytes. At B=2048, T=12000, C=128 B4 reads x
// (98 MB) and writes a_sel in bf16 (1.57 GB), 0.50 ms at 3.35 TB/s; B5
// reads x and g in f32 (3.15 GB), 0.97 ms; their 201 and 403 GFLOP take
// 0.20 and 0.41 ms at the bf16 tensor-core peak.
//
// block0_train_fwd / block0_train_bwd, the route of gemm_dtype float32: the
// conv as f32 FMAs on the CUDA cores, one thread per channel with its 32
// taps (B5: and its 32 dW sums) in registers, taps summed in order k = 0..31
// with each product rounded apart, bit for bit the plain version; the tile's
// input window in shared memory, read as a broadcast; a fixed number of
// CTAs each walk a fixed set of tiles and write one row of partial sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "block0_mma.cuh"
#include "fold.cuh"

namespace {

constexpr int kTile = 128;  // pooled outputs per tile of the f32 route
constexpr int kK = 32;      // taps
constexpr int kPool = 4;
constexpr int kPadL = (kK - 1) / 2;  // XLA's SAME for even k: 15 left, 16 right
constexpr int kWin = kPool * kTile + kK - 1;
constexpr int kFwdVals = 3;       // sum a, sum a^2, #(a > 0)
constexpr int kBwdVals = kK + 1;  // dW rows, then db
constexpr int kMaxThreads = 256;  // one thread per channel: C <= 256

// ---------------------------------------------------------------------------
// The f32 route: CUDA-core FMAs, bit for bit the plain version
// ---------------------------------------------------------------------------

// Stage the tile's input window.
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ xrow, long long t0,
                                      int T) {
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) {
    const long long t = t0 + i;
    xs[i] = (t >= 0 && t < T) ? xrow[t] : 0.f;
  }
}

// acc + x * w with the product rounded apart, as the plain version.
__device__ __forceinline__ float tap(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

// The four phases' relu activations of pooled position p.
__device__ __forceinline__ void phases(const float* xs, int p, const float (&wr)[kK], float bias,
                                       float (&a)[kPool]) {
  float xr[kPool + kK - 1];
#pragma unroll
  for (int i = 0; i < kPool + kK - 1; ++i) xr[i] = xs[p * kPool + i];
#pragma unroll
  for (int j = 0; j < kPool; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) acc = tap(acc, xr[j + k], wr[k]);
    a[j] = fmaxf(__fadd_rn(acc, bias), 0.f);
  }
}

template <bool SEL_BF16>
__global__ void __launch_bounds__(kMaxThreads)
block0_train_fwd(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ sgn,
                 void* __restrict__ sel, float* __restrict__ part, int B, int T, int C) {
  __shared__ float xs[kWin];
  const int c = threadIdx.x;
  const bool live = c < C;
  const int t_out = T / kPool;
  const int tiles_per_row = (t_out + kTile - 1) / kTile;
  const int n_tiles = B * tiles_per_row;
  float wr[kK];
  float bc = 0.f, sc = 1.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) wr[k] = live ? w[k * C + c] : 0.f;
  if (live) bc = bias[c], sc = sgn[c];
  float s1 = 0.f, s2 = 0.f, cnt = 0.f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int p0 = (tile % tiles_per_row) * kTile;
    __syncthreads();  // the previous tile's readers are done with xs
    stage(xs, x + (long long)b * T, (long long)p0 * kPool - kPadL, T);
    __syncthreads();
    if (!live) continue;
    const int n_p = min(kTile, t_out - p0);
    for (int p = 0; p < n_p; ++p) {
      float a[kPool];
      phases(xs, p, wr, bc, a);
      float best = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < kPool; ++j) {
        s1 = __fadd_rn(s1, a[j]);
        s2 = __fadd_rn(s2, __fmul_rn(a[j], a[j]));
        cnt += a[j] > 0.f ? 1.f : 0.f;
        best = fmaxf(best, __fmul_rn(a[j], sc));
      }
      const float v = __fmul_rn(best, sc);
      const long long o = ((long long)b * t_out + p0 + p) * C + c;
      if (SEL_BF16)
        static_cast<__nv_bfloat16*>(sel)[o] = __float2bfloat16(v);
      else
        static_cast<float*>(sel)[o] = v;
    }
  }
  if (live) {
    float* row = part + (long long)blockIdx.x * kFwdVals * C;
    row[c] = s1;
    row[C + c] = s2;
    row[2 * C + c] = cnt;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
block0_train_bwd(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ sgn,
                 const float* __restrict__ g, const float* __restrict__ cc,
                 float* __restrict__ part, int B, int T, int C) {
  __shared__ float xs[kWin];
  const int c = threadIdx.x;
  const bool live = c < C;
  const int t_out = T / kPool;
  const int tiles_per_row = (t_out + kTile - 1) / kTile;
  const int n_tiles = B * tiles_per_row;
  float wr[kK], dw[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) wr[k] = live ? w[k * C + c] : 0.f, dw[k] = 0.f;
  float bc = 0.f, sc = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, db = 0.f;
  if (live) bc = bias[c], sc = sgn[c], c0 = cc[c], c1 = cc[C + c], c2 = cc[2 * C + c];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int p0 = (tile % tiles_per_row) * kTile;
    __syncthreads();
    stage(xs, x + (long long)b * T, (long long)p0 * kPool - kPadL, T);
    __syncthreads();
    if (!live) continue;
    const int n_p = min(kTile, t_out - p0);
    for (int p = 0; p < n_p; ++p) {
      float a[kPool];
      phases(xs, p, wr, bc, a);
      float best = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < kPool; ++j) best = fmaxf(best, __fmul_rn(a[j], sc));
      const long long o = ((long long)b * t_out + p0 + p) * C + c;
      const float gv = g[o];
      bool taken = false;
#pragma unroll
      for (int j = 0; j < kPool; ++j) {
        const bool eq = !taken && __fmul_rn(a[j], sc) == best;
        taken = taken || eq;
        const float gj = eq ? gv : 0.f;
        const float dz = a[j] > 0.f
            ? __fadd_rn(__fadd_rn(__fmul_rn(c0, gj), c1), __fmul_rn(c2, a[j])) : 0.f;
        db = __fadd_rn(db, dz);
#pragma unroll
        for (int k = 0; k < kK; ++k) dw[k] = tap(dw[k], xs[p * kPool + j + k], dz);
      }
    }
  }
  if (live) {
    float* row = part + (long long)blockIdx.x * kBwdVals * C;
#pragma unroll
    for (int k = 0; k < kK; ++k) row[k * C + c] = dw[k];
    row[kK * C + c] = db;
  }
}

int check_shape(int B, int T, int C, int n_ctas) {
  const int t_out = T / kPool;
  const long long n_tiles = (long long)B * ((t_out + kTile - 1) / kTile);
  if (C < 1 || C > kMaxThreads || T % kPool || n_tiles < 1 || n_ctas < 1 ||
      n_ctas > n_tiles || n_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------------------------------
// The tensor-core route (gemm_dtype bf16)
// ---------------------------------------------------------------------------

using vm_block0::kGroup;
using vm_block0::kPrefetch;
using vm_block0::kSlice;
using vm_block0::kThreads;
using vm_block0::kWarps;
using vm_block0::kWRow;
constexpr int kGroupChannels = 4 * kSlice;  // channels of a CTA: 4 slices
constexpr int kCtasPerSm = 4;  // ops/block0_train_tc.CTAS_PER_SM

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// s · max_j(s · a_j) for s = ±1: the max where s > 0, else the min (the
// negations are exact), and the first phase in time order that holds it.
__device__ __forceinline__ float select_phase(const float (&a)[kPool], float s, int& route) {
  const float v = s > 0.f ? fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]))
                          : fminf(fminf(a[0], a[1]), fminf(a[2], a[3]));
  route = a[0] == v ? 0 : (a[1] == v ? 1 : (a[2] == v ? 2 : 3));
  return v;
}

__device__ __forceinline__ float warp_fold_groups(float v) {
  // The 8 lanes of one tq (lane bits 2-4), a butterfly: every lane ends
  // with the same sum.
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// One CTA: channel group sg = blockIdx.x % n_sg (channels [128·sg, +cg)),
// items (row b, tile of `tile` pooled positions) j + i·n_cps of the group,
// j = blockIdx.x / n_sg (ops/block0_train_tc.schedule). Warp w keeps slice
// w % n_s of the group and, where n_s < 4 slices, every wps-th 8-position
// group of a tile from w / n_s (n_s = 3: warp 3 idles).
// Shared memory (ops/block0_train_tc.smem_bytes): the group's packed
// weights and per-channel rows [bias | sgn (| c0 | c1 | c2)] for the CTA's
// life; B4's output tile; the warps' fold rows; B5's x4 window; the window
// as read (xe) and shifted by one sample (xo).
// STAGE (B5 only, on no path): also writes the recomputed s·max_j(s·a_j)
// in f32 and the routed phase, so a check can hold them to B4's.
// The per-channel vectors, (C,) f32 each: bias, sgn (B5: and c0, c1, c2).
struct Vecs {
  const float* p[5];
};

template <bool BWD, bool SEL_BF16, bool STAGE>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
block0_train_tc(const float* __restrict__ x, const float* __restrict__ w, long long w_sk,
                long long w_sc, Vecs vec, const float* __restrict__ gin,
                void* __restrict__ sel, unsigned char* __restrict__ route,
                float* __restrict__ part, int B, int T, int C, int tile, int n_cps,
                int row_bytes) {
  constexpr int kVecs = BWD ? 5 : 2;
  constexpr int kRed = BWD ? kBwdVals : kFwdVals;
  constexpr int kOutBytes = SEL_BF16 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t_out = T / kPool;
  const int n_tiles = (t_out + tile - 1) / tile;
  const int n_items = B * n_tiles;
  const int n_sg = (C + kGroupChannels - 1) / kGroupChannels;
  const int sg = blockIdx.x % n_sg, first = blockIdx.x / n_sg;
  const int c0g = sg * kGroupChannels;
  const int cg = min(kGroupChannels, C - c0g);
  const int n_s = (cg + kSlice - 1) / kSlice;
  const int cgp = min((C + kSlice - 1) / kSlice * kSlice, kGroupChannels);  // layout width
  const int window = 4 * tile + vm_block0::kTaps;

  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  unsigned char* otile = smem + cgp * kWRow * 2;
  float* vs = reinterpret_cast<float*>(otile + (BWD ? 0 : tile * row_bytes));
  float* red = vs + kVecs * cgp;
  uint32_t* x4 = reinterpret_cast<uint32_t*>(red + kWarps * kRed * kSlice);
  __nv_bfloat16* xe = reinterpret_cast<__nv_bfloat16*>(x4 + (BWD ? window : 0));
  __nv_bfloat16* xo = xe + window;
  const uint32_t* xe32 = reinterpret_cast<const uint32_t*>(xe);
  const uint32_t* xo32 = reinterpret_cast<const uint32_t*>(xo);

  // The group's weights w[k, c] (strides w_sk, w_sc) rounded to bf16 in
  // rows of kWRow taps, as ops/block0_tc.pack_weights packs them, zeros past
  // tap 32 and channel cg; and its per-channel rows.
  for (int i = threadIdx.x; i < n_s * kSlice * kWRow / 2; i += kThreads) {
    const int n = i / (kWRow / 2), k = 2 * (i - n * (kWRow / 2));
    float lo = 0.f, hi = 0.f;
    if (n < cg && k < vm_block0::kTaps) {
      const float* wc = w + (long long)(c0g + n) * w_sc;
      lo = wc[k * w_sk];
      hi = wc[(k + 1) * w_sk];
    }
    ws[i] = pack_bf16(lo, hi);
  }
  for (int i = threadIdx.x; i < kVecs * cgp; i += kThreads) {
    const int row = i / cgp, c = i - row * cgp;
    vs[i] = c < cg ? vec.p[row][c0g + c] : 0.f;
  }
  __syncthreads();

  const int wps = n_s == 3 ? 1 : 4 / n_s;
  const bool active = warp < n_s * wps;
  const int slice = warp % n_s, share = warp / n_s;
  const int n_groups = tile / kGroup;
  uint32_t bw[4][2][2];
  if (active) vm_block0::load_b_fragments(ws, slice * kSlice, g, tq, bw);
  // B4: sum a, sum a^2, #(a > 0); B5: dW (tap 16mt + g (+ 8), channel
  // nt·8 + 2tq + (i & 1)) and db, for the warp's slice over all its items.
  float st[4][2][3];
  float dw[2][4][4];
  float db[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      db[nt][e] = 0.f;
#pragma unroll
      for (int v = 0; v < 3; ++v) st[nt][e][v] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dw[mt][nt][i] = 0.f;
  }

  float pre[kPrefetch], pre4[kPrefetch];
  auto fetch = [&](int item) {
    const int b = item / n_tiles;
    const int p0 = (item - b * n_tiles) * tile;
    vm_block0::fetch_window(pre, x, b, p0, T, window);
    if (BWD) vm_block0::fetch_window(pre4, x, b, p0 + 1, T, window);  // 4 samples on
    if (BWD) {
      // The item's g rows into L2 one item ahead, by 128-byte lines: each
      // row's run of the group's channels, plus one line for a run that
      // straddles a line boundary.
      const int n_p = min(tile, t_out - p0);
      const char* base =
          reinterpret_cast<const char*>(gin + ((long long)b * t_out + p0) * C + c0g);
      const int lines = (cg * 4 + 127) / 128 + 1;
      for (int i = threadIdx.x; i < n_p * lines; i += kThreads) {
        const int r = i / lines, l = i - r * lines;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(base + (long long)r * C * 4 +
                                                       min(l * 128, cg * 4 - 4)));
      }
    }
  };
  if (first < n_items) fetch(first);
  for (int item = first; item < n_items; item += n_cps) {
    const int b = item / n_tiles;
    const int p0 = (item - b * n_tiles) * tile;
    const int n_p = min(tile, t_out - p0);
    vm_block0::store_window(pre, xe, xo, window);
    if (BWD) {
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < window - 4) x4[i] = pack_bf16(pre[k], pre4[k]);
      }
    }
    __syncthreads();
    if (item + n_cps < n_items) fetch(item + n_cps);

    for (int grp = share; active && grp < n_groups && grp * kGroup < n_p; grp += wps) {
      const int lp = grp * kGroup + g;  // this thread's pooled position
      const bool valid = lp < n_p;
      const long long orow = (long long)b * t_out + p0 + lp;
      float gv[4][2];
      if (BWD) {
        // The pooled cotangent of the thread's 8 channels, read in f32 and
        // rounded to bf16 here.
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = c0g + slice * kSlice + nt * 8 + 2 * tq;
          const float* src = gin + orow * C + c;
          float2 v = make_float2(0.f, 0.f);
          if (valid && c + 1 < C && (C & 1) == 0) {
            v = __ldg(reinterpret_cast<const float2*>(src));
          } else if (valid) {
            if (c < C) v.x = __ldg(src);
            if (c + 1 < C) v.y = __ldg(src + 1);
          }
          gv[nt][0] = __bfloat162float(__float2bfloat16(v.x));
          gv[nt][1] = __bfloat162float(__float2bfloat16(v.y));
        }
      }
      // The conv: the same fragments and the same chain of two mma for
      // each accumulator in both kernels, so B5's a_j are B4's bit for bit.
      uint32_t af[2][2][4];
      vm_block0::load_a_fragments(xe32, xo32, lp, tq, af);
      uint32_t ax[2][2][4];
      if (BWD) {
        // X's A fragments: rows are taps 16mt + g (+ 8), k pairs positions
        // 2tq, 2tq + 1 of phase 2s (registers 0, 1) or 2s + 1 (2, 3).
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int i0 = 4 * (grp * kGroup + 2 * tq) + 2 * s + 16 * mt + g;
            ax[mt][s][0] = x4[i0];
            ax[mt][s][1] = x4[i0 + 8];
            ax[mt][s][2] = x4[i0 + 1];
            ax[mt][s][3] = x4[i0 + 9];
          }
      }
      unsigned char* srow = otile + lp * row_bytes;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float acc[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
        vm_block0::tile_products(af, bw[nt], acc);
        float v[2], dz[2][kPool];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = slice * kSlice + nt * 8 + 2 * tq + e;
          // rows g, g + 8 of m-tile mt: phases 2mt, 2mt + 1; relu(y + bias)
          const float bias = vs[c];
          const float a[kPool] = {fmaxf(__fadd_rn(acc[0][e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[0][2 + e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[1][e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[1][2 + e], bias), 0.f)};
          int r;
          v[e] = select_phase(a, vs[cgp + c], r);
          if (!BWD) {
            if (valid) {
              st[nt][e][0] = __fadd_rn(st[nt][e][0],
                                       __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])));
#pragma unroll
              for (int j = 0; j < kPool; ++j) {
                st[nt][e][1] = fmaf(a[j], a[j], st[nt][e][1]);
                st[nt][e][2] += a[j] > 0.f ? 1.f : 0.f;
              }
            }
          } else {
            const float k0 = vs[2 * cgp + c], k1 = vs[3 * cgp + c], k2 = vs[4 * cgp + c];
            // (c0·g_j + c1): c1 itself where g_j = 0, as 0 + c1 rounds
            const float kg = __fadd_rn(__fmul_rn(k0, gv[nt][e]), k1);
#pragma unroll
            for (int j = 0; j < kPool; ++j) {
              const float d = valid && a[j] > 0.f
                  ? __fadd_rn(j == r ? kg : k1, __fmul_rn(k2, a[j])) : 0.f;
              db[nt][e] = __fadd_rn(db[nt][e], d);
              dz[e][j] = d;
            }
            if (STAGE && valid && c < cg) {
              const long long o = orow * C + c0g + c;
              static_cast<float*>(sel)[o] = v[e];
              route[o] = (unsigned char)r;
            }
          }
        }
        if (!BWD) {
          const int c = slice * kSlice + nt * 8 + 2 * tq;
          if (c < cg) {
            if (SEL_BF16) {
              __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(srow) + c;
              if (c + 1 < cg)
                *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v[0], v[1]);
              else
                d[0] = __float2bfloat16(v[0]);
            } else {
              float* d = reinterpret_cast<float*>(srow) + c;
              if (c + 1 < cg)
                *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
              else
                d[0] = v[0];
            }
          }
        } else {
          // dz of (position g, channels 2tq, 2tq + 1) for each phase, bf16,
          // transposed: channel g's dz at positions 2tq, 2tq + 1.
          uint32_t bz[kPool];
#pragma unroll
          for (int j = 0; j < kPool; ++j) bz[j] = movmatrix_trans(pack_bf16(dz[0][j], dz[1][j]));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              vm_block0::mma_bf16(dw[mt][nt], ax[mt][s], bz[2 * s], bz[2 * s + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the window (and B4's tile is whole)
    if (!BWD) {
      // The tile's n_p rows of the group's cg channels: 16-byte vectors
      // where the rows are whole vectors, else element by element.
      unsigned char* gout = static_cast<unsigned char*>(sel) +
                            (((long long)b * t_out + p0) * C + c0g) * kOutBytes;
      const int rb = cg * kOutBytes, gstride = C * kOutBytes;
      if (rb % 16 == 0 && gstride % 16 == 0) {
        const int ch = rb / 16;
        for (int i = threadIdx.x; i < n_p * ch; i += kThreads) {
          const int p = i / ch, v = i - p * ch;
          *reinterpret_cast<uint4*>(gout + (long long)p * gstride + 16 * v) =
              *reinterpret_cast<const uint4*>(otile + p * row_bytes + 16 * v);
        }
      } else {
        for (int i = threadIdx.x; i < n_p * cg; i += kThreads) {
          const int p = i / cg, c = i - p * cg;
          const unsigned char* src = otile + p * row_bytes + c * kOutBytes;
          unsigned char* dst = gout + (long long)p * gstride + c * kOutBytes;
#pragma unroll
          for (int k = 0; k < kOutBytes; ++k) dst[k] = src[k];
        }
      }
      // The next item's first sync orders these reads before its writes.
    }
  }

  // Fold: the lanes of a channel by shuffles, then each warp's row of its
  // slice in shared memory, then the warps of each slice in warp order.
  float* wred = red + warp * kRed * kSlice;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = nt * 8 + 2 * tq + e;
      if (BWD) {
        const float v = warp_fold_groups(db[nt][e]);
        if (g == 0) wred[kK * kSlice + ch] = v;
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float s = warp_fold_groups(st[nt][e][v]);
          if (g == 0) wred[v * kSlice + ch] = s;
        }
      }
    }
  if (BWD) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wred[(16 * mt + g + 8 * (i >> 1)) * kSlice + nt * 8 + 2 * tq + (i & 1)] = dw[mt][nt][i];
  }
  __syncthreads();
  float* row = part + (long long)blockIdx.x * kRed * C;
  for (int i = threadIdx.x; i < kRed * C; i += kThreads) {
    const int v = i / C, c = i - v * C - c0g;
    float s = 0.f;
    if (c >= 0 && c < cg) {
      const int sl = c / kSlice;
      for (int wi = sl; wi < n_s * wps; wi += n_s)
        s = __fadd_rn(s, red[(wi * kRed + v) * kSlice + c - sl * kSlice]);
    }
    row[i] = s;
  }
}

int tc_smem_bytes(bool bwd, int C, int tile, int out_bytes, int* row_bytes) {
  const int cgp = std::min((C + kSlice - 1) / kSlice * kSlice, kGroupChannels);
  const int window = 4 * tile + vm_block0::kTaps;
  *row_bytes = (std::min(C, kGroupChannels) * out_bytes + 15) / 16 * 16 + 16;
  return cgp * kWRow * 2 + (bwd ? 0 : tile * *row_bytes) + (bwd ? 5 : 2) * cgp * 4 +
         kWarps * (bwd ? kBwdVals : kFwdVals) * kSlice * 4 + (bwd ? 4 * window : 0) +
         4 * window;
}

template <bool BWD, bool SEL_BF16, bool STAGE>
int launch_tc(const void* x, const void* w, long long w_sk, long long w_sc, Vecs vec,
              const void* g, void* sel, void* route, void* part, void* out, int B, int T, int C,
              int tile, int n_cps, cudaStream_t stream) {
  if (C < 1 || C > kMaxThreads || T % kPool || T < kPool || B < 1 || n_cps < 1 ||
      (tile != 16 && tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  const int t_out = T / kPool;
  const long long items = (long long)B * ((t_out + tile - 1) / tile);
  const int n_sg = (C + kGroupChannels - 1) / kGroupChannels;
  if (items > 0x7fffffffLL || n_cps > items || (long long)n_cps * n_sg > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int row_bytes = 0;
  const int smem = tc_smem_bytes(BWD, C, tile, SEL_BF16 ? 2 : 4, &row_bytes);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = block0_train_tc<BWD, SEL_BF16, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ctas = n_cps * n_sg;
  kernel<<<n_ctas, kThreads, smem, stream>>>((const float*)x, (const float*)w, w_sk, w_sc, vec,
                                              (const float*)g, sel, (unsigned char*)route,
                                              (float*)part, B, T, C, tile, n_cps, row_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vm_fold::fold_rows((float*)part, n_ctas, (BWD ? kBwdVals : kFwdVals) * C, (float*)out, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 route. x (B, T) f32; w (32, C) f32; bias, sgn (C,) f32;
// sel (B, T/4, C) f32 or bf16; part (n_ctas, 3, C) f32 scratch;
// stats (3, C) f32 out.
extern "C" int vm_block0_train_fwd(const void* x, const void* w, const void* bias,
                                   const void* sgn, void* sel, void* part, void* stats,
                                   int B, int T, int C, int n_ctas, int sel_bf16, void* stream) {
  if (int err = check_shape(B, T, C, n_ctas)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((C + 31) / 32) * 32;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)bias,
              *sf = (const float*)sgn;
  float* pf = (float*)part;
  if (sel_bf16)
    block0_train_fwd<true><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  else
    block0_train_fwd<false><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, n_ctas, kFwdVals * C, (float*)stats, s);
  return (int)cudaGetLastError();
}

// The f32 route. g (B, T/4, C) f32; cc (3, C) f32: c0, c1, c2;
// part (n_ctas, 33, C) f32 scratch; out (33, C) f32: dW rows k = 0..31, db.
extern "C" int vm_block0_train_bwd(const void* x, const void* w, const void* bias,
                                   const void* sgn, const void* g, const void* cc,
                                   void* part, void* out, int B, int T, int C, int n_ctas,
                                   void* stream) {
  if (int err = check_shape(B, T, C, n_ctas)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((C + 31) / 32) * 32;
  float* pf = (float*)part;
  block0_train_bwd<<<n_ctas, threads, 0, s>>>((const float*)x, (const float*)w,
                                              (const float*)bias, (const float*)sgn,
                                              (const float*)g, (const float*)cc, pf, B, T, C);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, n_ctas, kBwdVals * C, (float*)out, s);
  return (int)cudaGetLastError();
}

// The tensor-core route of B4. x (B, T) f32; w: element (k, c) of the
// (32, C) f32 weights at w + k·w_sk + c·w_sc; bias, sgn (C,) f32;
// sel (B, T/4, C) f32 or bf16; part (n_sg·n_cps, 3, C) f32 scratch, n_sg =
// ceil(C / 128); stats (3, C) f32 out; tile and n_cps from
// ops/block0_train_tc.grid. A CTA that does not fit shared memory returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int vm_block0_train_tc_fwd(const void* x, const void* w, long long w_sk,
                                      long long w_sc, const void* bias, const void* sgn,
                                      void* sel, void* part, void* stats, int B, int T, int C,
                                      int tile, int n_cps, int sel_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs vec = {{(const float*)bias, (const float*)sgn, nullptr, nullptr, nullptr}};
  if (sel_bf16)
    return launch_tc<false, true, false>(x, w, w_sk, w_sc, vec, nullptr, sel, nullptr, part,
                                         stats, B, T, C, tile, n_cps, s);
  return launch_tc<false, false, false>(x, w, w_sk, w_sc, vec, nullptr, sel, nullptr, part,
                                        stats, B, T, C, tile, n_cps, s);
}

// The tensor-core route of B5. bias, sgn, c0, c1, c2 (C,) f32; g (B, T/4,
// C) f32; part (n_sg·n_cps, 33, C) f32 scratch; out (33, C) f32: dW rows
// k = 0..31, db. sel and route: NULL, or (the stage entry, on no path) what
// it recomputed, (B, T/4, C) f32 s·max_j(s·a_j) and uint8 the phase it
// routed g to, so a check can hold sel to B4's a_sel bit for bit.
extern "C" int vm_block0_train_tc_bwd(const void* x, const void* w, long long w_sk,
                                      long long w_sc, const void* bias, const void* sgn,
                                      const void* c0, const void* c1, const void* c2,
                                      const void* g, void* part, void* out, void* sel,
                                      void* route, int B, int T, int C, int tile, int n_cps,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs vec = {{(const float*)bias, (const float*)sgn, (const float*)c0, (const float*)c1,
                     (const float*)c2}};
  if (sel || route) {
    if (!sel || !route) return (int)cudaErrorInvalidValue;
    return launch_tc<true, false, true>(x, w, w_sk, w_sc, vec, g, sel, route, part, out, B, T, C,
                                        tile, n_cps, s);
  }
  return launch_tc<true, false, false>(x, w, w_sk, w_sc, vec, g, nullptr, nullptr, part, out, B,
                                       T, C, tile, n_cps, s);
}
