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
// block0_train_tc32, the route of gemm_dtype float32: the same plan (grid,
// items, epilogue in registers, fold) with the conv in 3xTF32 on the tensor
// cores (tf32x3.cuh: each operand split into a tf32 big and small part,
// three products a product), as the TPU kernel ran its f32 product at the
// ambient 'highest' precision, a multi-pass product on its matrix unit
// (voicemap_tpu/ops/pallas_conv.py :: mxu_precision):
// - the conv on wgmma m64n32k8: a CTA keeps one 32-channel slice, its
//   weights split once into big and small planes in wgmma's K-major layout
//   (B); each warp's 16 A rows are its own unit's two phases of 8
//   positions, the Toeplitz view of the item's window, split once when
//   staged into (big, small) pairs and loaded into registers in mma's
//   fragment layout, so a position's four phases land in one thread's
//   accumulators (B2's direct form); the epilogue one n8 tile at a time;
//   B4 stores a_sel straight from registers (no output tile and no barrier
//   before the stores);
// - B5 computes the same sums through the same function (conv_products32),
//   so its a_j and routes are B4's bit for bit; its dz and db stay f32, and
//   its weight gradient is a second 3xTF32 product per unit on mma.sync
//   m16n8k8 (its M, the 32 taps, is under wgmma's 64): the warp writes its
//   dz to its own shared rows (phase-major: row 8j + p), and dW += X · dZ
//   with X the window's Toeplitz view read from the split window and dZ's
//   B fragments split on the load.
// Against the plain version, which rounds each product and sum in tap order,
// a_sel agrees to an order bound (ops/block0_train_tc.sel_bound with the
// unit of 3xTF32 and its f32 sums, tf32x3_unit) and #(a > 0) and B5's
// routes may flip only within it. What bounds it on the H100: at B=2048,
// T=12000, C=128 the 1.007e11 taps' three products a tap take 1.22 ms at
// the TF32 peak; writing a_sel in f32 (3.15 GB) 0.94 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "block0_mma.cuh"
#include "fold.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kK = 32;      // taps
constexpr int kPool = 4;
constexpr int kFwdVals = 3;       // sum a, sum a^2, #(a > 0)
constexpr int kBwdVals = kK + 1;  // dW rows, then db
constexpr int kMaxChannels = 256;  // the widest C the kernels take

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
// in f32 and a byte of the routed phase and the four phases' relu masks,
// so a check can hold them to B4's and feed them to the plain dW.
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
              // the routed phase in bits 0-1, phase j's a_j > 0 in bit 2 + j
              route[o] = (unsigned char)(r | (a[0] > 0.f) << 2 | (a[1] > 0.f) << 3 |
                                         (a[2] > 0.f) << 4 | (a[3] > 0.f) << 5);
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

// ---------------------------------------------------------------------------
// The f32 route (gemm_dtype float32): the same plan in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kWTile32 = kSlice * 8;  // floats of one plane of a k8 step's weight tile
constexpr int kDz32Rows = 32;   // B5: a unit's full-rate positions, phase-major
constexpr int kDz32Pitch = 40;  // B5: f32 channels a dz row: 32 + 8 (writes and B loads miss)
constexpr int kCtasPerSm32 = 3;  // ops/block0_train_tc.CTAS_PER_SM_F32
static_assert(kWarps * kBwdVals * kSlice <= kWarps * kDz32Rows * kDz32Pitch,
              "B5's fold rows reuse its dz rows");

// B5's dW step, acc[mt][nt] += A[mt]·B[nt] in 3xTF32 on mma.sync for every
// (mt, nt): each of the three products in 3xTF32's order (small·big,
// big·small, big·big, as wgmma3) over all eight accumulators in turn, so
// that no product waits on the one before it.
__device__ __forceinline__ void mma3_tiles(float (&acc)[2][4][4], const vm_tf32x3::FragA (&a)[2],
                                           const vm_tf32x3::FragB (&b)[4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      vm_tf32x3::mma_tf32(acc[mt][nt], a[mt].small, b[nt].big[0], b[nt].big[1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      vm_tf32x3::mma_tf32(acc[mt][nt], a[mt].big, b[nt].small[0], b[nt].small[1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      vm_tf32x3::mma_tf32(acc[mt][nt], a[mt].big, b[nt].big[0], b[nt].big[1]);
}

// The word of weight (channel n, tap k) in the CTA's weight tiles: k8 step
// s = k / 8 and plane (0 big, 1 small) pick a tile of kWTile32 floats; in
// it, wgmma's K-major layout without swizzle (tf32x3.cuh :: desc_kmajor):
// n8 group n / 8 every 64 words, taps 4-7 of the step 32 words after 0-3,
// a core matrix's row n % 8 every 4 words.
__device__ __forceinline__ int wtile_word(int n, int k, int plane) {
  return (2 * (k >> 3) + plane) * kWTile32 + (n >> 3) * 64 + ((k >> 2) & 1) * 32 + (n & 7) * 4 +
         (k & 3);
}

// The conv sums of the warpgroup's four units in 3xTF32 on wgmma m64n32k8:
// each warp's unit is 8 pooled positions from window sample u (= 32·grp,
// its own), all of them the slice's 32 channels, from zero, in B2's direct
// form (acc[mt][4nt + i] holds what mma.sync's acc[mt][nt][i] would: rows g
// and g + 8 of the warp's 16 rows of m-tile mt are phases 2mt and 2mt + 1
// of position g). A's element (row, k) of k8 step s is window sample u + 4g
// + j + 8s + k, read into registers from the split window; B the weight
// tiles (wtile_word). The steps in order s = 0..3, each step's three
// products in wgmma3's order: B4 and B5 both call this, so their sums agree
// bit for bit. Every warp of the CTA calls it together.
__device__ __forceinline__ void conv_products32(const uint2* xw, const uint32_t* wt, int u, int g,
                                                int tq, float (&acc)[2][16]) {
  vm_tf32x3::FragA a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      vm_tf32x3::load_a(a[mt][s], xw + u + 2 * mt + 8 * s, 4 * g, 4 * g + 1, tq, tq + 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mt][i] = 0.f;
  vm_tf32x3::fence_acc(acc[0]);
  vm_tf32x3::fence_acc(acc[1]);
  vm_tf32x3::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      vm_tf32x3::wgmma3<kSlice>(acc[mt], a[mt][s],
                                vm_tf32x3::desc_kmajor(wt + (2 * s) * kWTile32),
                                vm_tf32x3::desc_kmajor(wt + (2 * s + 1) * kWTile32));
  vm_tf32x3::wgmma_commit();
  vm_tf32x3::wgmma_wait<0>();
  vm_tf32x3::fence_acc(acc[0]);
  vm_tf32x3::fence_acc(acc[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int s = 0; s < 4; ++s) vm_tf32x3::fence_a(a[mt][s]);
}

// block0_train_tc's plan (grid, items, epilogue, fold) with the conv in
// 3xTF32 on wgmma (conv_products32) and f32 operands. A CTA keeps one slice
// of 32 channels (its group) for its life, so that its four warps share the
// weights as wgmma's B; each warp takes every fourth unit of an item, the
// four together (a warp past the item's units computes a masked one). B4
// writes a_sel from registers, with no output tile. Shared memory
// (ops/block0_train_tc.smem_bytes, kinds fwd_f32 / bwd_f32): the slice's
// weight tiles split into big and small planes, for the CTA's life; the
// per-channel rows; the fold rows (B5: the warps' dz rows first, the fold
// rows in their place after the last item); the window split into (big,
// small) pairs once when staged.
// B5's weight gradient, after each unit's epilogue: the warp writes its dz
// (f32, 0 where a_j <= 0 or past the tile) to its rows, row 8j + p for phase
// j of the unit's position p, and dW (32 taps x the slice's 32 channels) +=
// X (taps x the 32 rows) · dZ (the rows x channels) in 3xTF32, X the
// window's Toeplitz view (X[k][8j + p] = window[u + 4p + j + k]) read
// straight from the split window, dZ's B fragments split on the load.
template <bool BWD, bool SEL_BF16, bool STAGE>
__global__ void __launch_bounds__(kThreads, kCtasPerSm32)
block0_train_tc32(const float* __restrict__ x, const float* __restrict__ w, long long w_sk,
                  long long w_sc, Vecs vec, const float* __restrict__ gin,
                  void* __restrict__ sel, unsigned char* __restrict__ route,
                  float* __restrict__ part, int B, int T, int C, int tile, int n_cps,
                  int /*row_bytes: the bf16 route's output tile*/) {
  constexpr int kVecs = BWD ? 5 : 2;
  constexpr int kRed = BWD ? kBwdVals : kFwdVals;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t_out = T / kPool;
  const int n_tiles = (t_out + tile - 1) / tile;
  const int n_items = B * n_tiles;
  const int n_sg = (C + kSlice - 1) / kSlice;
  const int sg = blockIdx.x % n_sg, first = blockIdx.x / n_sg;
  const int c0g = sg * kSlice;
  const int cg = min(kSlice, C - c0g);
  const int window = 4 * tile + vm_block0::kTaps;

  uint32_t* wt = reinterpret_cast<uint32_t*>(smem);
  float* vs = reinterpret_cast<float*>(smem) + 8 * kWTile32;
  float* red = vs + kVecs * kSlice;
  uint2* xw = reinterpret_cast<uint2*>(
      red + (BWD ? kWarps * kDz32Rows * kDz32Pitch : kWarps * kRed * kSlice));

  // The slice's weights w[k, c] (strides w_sk, w_sc) split into the tiles,
  // zeros past channel cg, for wgmma's reads; and its per-channel rows.
  for (int i = threadIdx.x; i < kSlice * kK; i += kThreads) {
    const int n = i / kK, k = i - n * kK;
    const float v = n < cg ? w[k * w_sk + (c0g + n) * w_sc] : 0.f;
    const uint2 p = vm_tf32x3::split2(v);
    wt[wtile_word(n, k, 0)] = p.x;
    wt[wtile_word(n, k, 1)] = p.y;
  }
  for (int i = threadIdx.x; i < kVecs * kSlice; i += kThreads) {
    const int row = i / kSlice, c = i - row * kSlice;
    vs[i] = c < cg ? vec.p[row][c0g + c] : 0.f;
  }
  vm_tf32x3::fence_proxy_async();  // the tiles, to the products' reads
  __syncthreads();

  const int n_groups = tile / kGroup;
  float* dzw = red + warp * kDz32Rows * kDz32Pitch;  // B5: this warp's dz rows
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

  float pre[kPrefetch];
  auto fetch = [&](int item) {
    const int b = item / n_tiles;
    const int p0 = (item - b * n_tiles) * tile;
    vm_block0::fetch_window(pre, x, b, p0, T, window);
    if (BWD) {
      // The item's g rows into L2 one item ahead, as block0_train_tc does.
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
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < window) xw[i] = vm_tf32x3::split2(pre[k]);
    }
    __syncthreads();
    if (item + n_cps < n_items) fetch(item + n_cps);

    // The item's units that hold a position, four at a time, one a warp; a
    // warp past them computes the last unit again, every position masked.
    const int n_units = min(n_groups, (n_p + kGroup - 1) / kGroup);
    for (int q0 = 0; q0 < n_units; q0 += kWarps) {
      const int grp = min(q0 + warp, n_groups - 1);
      const int lp = grp * kGroup + g;  // this thread's pooled position
      const bool valid = q0 + warp < n_units && lp < n_p;
      const long long orow = (long long)b * t_out + p0 + lp;
      const int u = kPool * kGroup * grp;  // the unit's first window sample
      float gv[4][2];
      if (BWD) {
        // The pooled cotangent of the thread's 8 channels, in f32.
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = c0g + nt * 8 + 2 * tq;
          const float* src = gin + orow * C + c;
          float2 v = make_float2(0.f, 0.f);
          if (valid && c + 1 < C && (C & 1) == 0) {
            v = __ldg(reinterpret_cast<const float2*>(src));
          } else if (valid) {
            if (c < C) v.x = __ldg(src);
            if (c + 1 < C) v.y = __ldg(src + 1);
          }
          gv[nt][0] = v.x;
          gv[nt][1] = v.y;
        }
      }
      float acc[2][16];
      conv_products32(xw, wt, u, g, tq, acc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v[2], dz[2][kPool];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * tq + e;
          // rows g, g + 8 of m-tile mt: phases 2mt, 2mt + 1; relu(y + bias)
          const float bias = vs[c];
          const float a[kPool] = {fmaxf(__fadd_rn(acc[0][4 * nt + e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[0][4 * nt + 2 + e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[1][4 * nt + e], bias), 0.f),
                                  fmaxf(__fadd_rn(acc[1][4 * nt + 2 + e], bias), 0.f)};
          int r;
          v[e] = select_phase(a, vs[kSlice + c], r);
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
            const float k0 = vs[2 * kSlice + c], k1 = vs[3 * kSlice + c], k2 = vs[4 * kSlice + c];
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
              // the routed phase in bits 0-1, phase j's a_j > 0 in bit 2 + j
              route[o] = (unsigned char)(r | (a[0] > 0.f) << 2 | (a[1] > 0.f) << 3 |
                                         (a[2] > 0.f) << 4 | (a[3] > 0.f) << 5);
            }
          }
        }
        if (!BWD) {
          // Straight from registers to device memory: the stores need no
          // barrier and run under the next unit's products. A warp's store
          // covers 8 rows x 32 bytes (f32) of whole sectors.
          const int c = nt * 8 + 2 * tq;
          if (valid && c < cg) {
            const long long o = orow * C + c0g + c;
            const bool pair = c + 1 < cg && (o & 1) == 0;
            if (SEL_BF16) {
              __nv_bfloat16* d = static_cast<__nv_bfloat16*>(sel) + o;
              if (pair) {
                *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v[0], v[1]);
              } else {
                d[0] = __float2bfloat16(v[0]);
                if (c + 1 < cg) d[1] = __float2bfloat16(v[1]);
              }
            } else {
              float* d = static_cast<float*>(sel) + o;
              if (pair) {
                *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
              } else {
                d[0] = v[0];
                if (c + 1 < cg) d[1] = v[1];
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kPool; ++j)
            *reinterpret_cast<float2*>(dzw + (8 * j + g) * kDz32Pitch + nt * 8 + 2 * tq) =
                make_float2(dz[0][j], dz[1][j]);
        }
      }
      if (BWD) {
        __syncwarp();  // the warp's dz rows are whole
        // dW += X · dZ, k8 step ks = phase ks: X's A (tap 16mt + g (+ 8),
        // row tq (+ 4) = position tq (+ 4) of the phase) at window sample
        // u + 4·position + ks + tap; dZ's B (row tq (+ 4), channel 8nt + g).
#pragma unroll
        for (int ks = 0; ks < kPool; ++ks) {
          vm_tf32x3::FragA xa[2];
          vm_tf32x3::FragB bz[4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            vm_tf32x3::load_a(xa[mt], xw + u + ks + 16 * mt, g, g + 8, 4 * tq, 4 * tq + 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            vm_tf32x3::load_b(bz[nt], dzw + 8 * ks * kDz32Pitch + 8 * nt, tq * kDz32Pitch,
                              (tq + 4) * kDz32Pitch, g);
          mma3_tiles(dw, xa, bz);
        }
        __syncwarp();  // the warp's products have read its dz rows
      }
    }
    __syncthreads();  // every warp is done with the window
  }

  // Fold, as block0_train_tc: the lanes of a channel by shuffles, then each
  // warp's row in shared memory (B5: over its dz rows, which the last
  // item's sync has freed), then the four warps in warp order.
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
    if (c >= 0 && c < cg)
      for (int wi = 0; wi < kWarps; ++wi) s = __fadd_rn(s, red[(wi * kRed + v) * kSlice + c]);
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

int tc32_smem_bytes(bool bwd, int /*C*/, int tile, int /*out_bytes*/, int* row_bytes) {
  const int window = 4 * tile + vm_block0::kTaps;
  *row_bytes = 0;
  return 8 * kWTile32 * 4 + (bwd ? 5 : 2) * kSlice * 4 +
         (bwd ? kWarps * kDz32Rows * kDz32Pitch : kWarps * kFwdVals * kSlice) * 4 + 8 * window;
}

// F32: block0_train_tc32 (gemm_dtype float32), else block0_train_tc.
template <bool F32, bool BWD, bool SEL_BF16, bool STAGE>
int launch_tc(const void* x, const void* w, long long w_sk, long long w_sc, Vecs vec,
              const void* g, void* sel, void* route, void* part, void* out, int B, int T, int C,
              int tile, int n_cps, cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels || T % kPool || T < kPool || B < 1 || n_cps < 1 ||
      (tile != 16 && tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  const int t_out = T / kPool;
  const long long items = (long long)B * ((t_out + tile - 1) / tile);
  const int group = F32 ? kSlice : kGroupChannels;  // channels of a CTA
  const int n_sg = (C + group - 1) / group;
  if (items > 0x7fffffffLL || n_cps > items || (long long)n_cps * n_sg > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int row_bytes = 0;
  const int smem = (F32 ? tc32_smem_bytes : tc_smem_bytes)(BWD, C, tile, SEL_BF16 ? 2 : 4,
                                                           &row_bytes);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = F32 ? block0_train_tc32<BWD, SEL_BF16, STAGE> : block0_train_tc<BWD, SEL_BF16, STAGE>;
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

// B4. x (B, T) f32; w: element (k, c) of the (32, C) f32 weights at w +
// k·w_sk + c·w_sc; bias, sgn (C,) f32; sel (B, T/4, C) f32 or bf16; part
// (n_sg·n_cps, 3, C) f32 scratch, n_sg = ceil(C / 128) (bf16 GEMM) or
// ceil(C / 32) (f32); stats (3, C) f32
// out; tile and n_cps from ops/block0_train_tc.grid; gemm_f32: the f32
// route (block0_train_tc32), else the bf16 GEMM (block0_train_tc). A CTA
// that does not fit shared memory returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int vm_block0_train_tc_fwd(const void* x, const void* w, long long w_sk,
                                      long long w_sc, const void* bias, const void* sgn,
                                      void* sel, void* part, void* stats, int B, int T, int C,
                                      int tile, int n_cps, int sel_bf16, int gemm_f32,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs vec = {{(const float*)bias, (const float*)sgn, nullptr, nullptr, nullptr}};
  auto launch = sel_bf16 ? (gemm_f32 ? launch_tc<true, false, true, false>
                                     : launch_tc<false, false, true, false>)
                         : (gemm_f32 ? launch_tc<true, false, false, false>
                                     : launch_tc<false, false, false, false>);
  return launch(x, w, w_sk, w_sc, vec, nullptr, sel, nullptr, part, stats, B, T, C, tile, n_cps,
                s);
}

// B5. bias, sgn, c0, c1, c2 (C,) f32; g (B, T/4, C) f32; part (n_sg·n_cps,
// 33, C) f32 scratch; out (33, C) f32: dW rows k = 0..31, db; gemm_f32 as
// for B4. sel and route: NULL, or (the stage entry, on no path) what it
// recomputed, (B, T/4, C) f32 s·max_j(s·a_j) and uint8 the phase it routed
// g to (bits 0-1) and a_j > 0 of phase j (bit 2 + j), so a check can hold
// sel to B4's f32 a_sel bit for bit and the plain dW can take B5's routes.
extern "C" int vm_block0_train_tc_bwd(const void* x, const void* w, long long w_sk,
                                      long long w_sc, const void* bias, const void* sgn,
                                      const void* c0, const void* c1, const void* c2,
                                      const void* g, void* part, void* out, void* sel,
                                      void* route, int B, int T, int C, int tile, int n_cps,
                                      int gemm_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Vecs vec = {{(const float*)bias, (const float*)sgn, (const float*)c0, (const float*)c1,
                     (const float*)c2}};
  if ((sel == nullptr) != (route == nullptr)) return (int)cudaErrorInvalidValue;
  auto launch = sel ? (gemm_f32 ? launch_tc<true, true, false, true>
                                : launch_tc<false, true, false, true>)
                    : (gemm_f32 ? launch_tc<true, true, false, false>
                                : launch_tc<false, true, false, false>);
  return launch(x, w, w_sk, w_sc, vec, g, sel, route, part, out, B, T, C, tile, n_cps, s);
}
