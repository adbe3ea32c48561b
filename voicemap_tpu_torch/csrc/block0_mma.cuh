// Block 0's conv on the tensor cores: the main loop shared by B2
// (conv_block0.cu :: conv_block0_tc_kernel) and B4/B5
// (conv_block0_train.cu :: block0_train_tc).
//
// The conv (Cin = 1, k = 32, SAME 15 left / 16 right, pool 4) as mma.sync
// m16n8k16 bf16 -> f32 in the direct form (ops/block0_tc.py): M = full-rate
// conv rows, K = the 32 taps (two k16 steps), N = the channels. A warp's unit
// is 8 pooled positions x 32 channels (a slice): two m16 tiles whose rows g
// and g + 8 are phases 2mt and 2mt + 1 of position g, so that a position's
// four phases land in one thread's accumulators:
//   acc[mt][nt][e]      phase 2mt      of channel nt*8 + 2tq + e
//   acc[mt][nt][2 + e]  phase 2mt + 1  of the same channel
// (g = lane / 4, tq = lane % 4). Pieces:
// - the window of an item (4·tile + 32 samples, zeros outside [0, T)) is
//   fetched into registers one item ahead (fetch_window) and staged in
//   shared memory in bf16 twice (store_window): as read (xe) and shifted by
//   one sample (xo), so every A fragment register, two consecutive samples,
//   is one aligned 32-bit load whatever the phase's parity;
// - the packed weights (ops/block0_tc.pack_weights: a channel's 32 taps in
//   a row of kWRow bf16, the 8 of padding keep the B fragment loads off each
//   other's banks) sit in shared memory for a CTA's life and a slice's B
//   fragments in registers (load_b_fragments);
// - load_a_fragments and tile_products (one n8 tile's four mma), or
//   unit_products (all four tiles at once): each accumulator's sum is the
//   same chain of two mma either way, so kernels that call them on the same
//   window and weights get the same sums bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage: each translation unit that includes this has its own copy.
namespace vm_block0 {
namespace {

constexpr int kThreads = 128;  // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 32;
constexpr int kPadL = (kTaps - 1) / 2;  // XLA's SAME for even k: 15 left, 16 right
constexpr int kWRow = 40;   // bf16 taps a channel row: 32 + 8 of padding
constexpr int kSlice = 32;  // channels of a warp's unit
constexpr int kGroup = 8;   // pooled positions of a warp's unit
constexpr int kMaxTile = 64;
constexpr int kPrefetch = (4 * kMaxTile + kTaps + 1 + kThreads - 1) / kThreads;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's share of the window of row b from pooled position p0 (4·tile +
// 33 samples from t = 4·p0 − 15, zeros outside [0, T)) into registers,
// issued one item ahead so its latency passes under the current item's
// products.
__device__ __forceinline__ void fetch_window(float* pre, const float* __restrict__ x, int b,
                                             int p0, int T, int window) {
  const long long t0 = 4LL * p0 - kPadL;
  const float* xrow = x + (long long)b * T;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const long long t = t0 + i;
    pre[k] = (i <= window && t >= 0 && t < T) ? xrow[t] : 0.f;
  }
}

// The fetched window, rounded to bf16 once (as the plain versions round x),
// into xe (as read) and xo (shifted by one sample). The caller syncs.
__device__ __forceinline__ void store_window(const float* pre, __nv_bfloat16* xe,
                                             __nv_bfloat16* xo, int window) {
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i <= window) {
      const __nv_bfloat16 v = __float2bfloat16(pre[k]);
      if (i < window) xe[i] = v;
      if (i > 0) xo[i - 1] = v;
    }
  }
}

// The B fragments of the slice whose first channel is row `n0` of ws:
// column n0 + nt·8 + g, taps 16s + 2tq (+1) and + 8 (+9).
__device__ __forceinline__ void load_b_fragments(const uint32_t* ws, int n0, int g, int tq,
                                                 uint32_t (&bw)[4][2][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + nt * 8 + g;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int wd = (n * kWRow + 16 * s + 2 * tq) >> 1;
      bw[nt][s][0] = ws[wd];
      bw[nt][s][1] = ws[wd + 4];
    }
  }
}

// A unit's A fragments: rows g and g + 8 of m-tile mt are phases 2mt and
// 2mt + 1 of pooled position lp (within the item; ops/block0_tc.phase_rows);
// element (row, k) is window sample 4·lp + j + k. Phase 2mt starts even
// (xe), 2mt + 1 odd, read from xo one sample earlier.
__device__ __forceinline__ void load_a_fragments(const uint32_t* xe32, const uint32_t* xo32,
                                                 int lp, int tq, uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = (4 * lp + 2 * mt + 16 * s + 2 * tq) >> 1;  // word of the even phase
      a[mt][s][0] = xe32[e];
      a[mt][s][1] = xo32[e];
      a[mt][s][2] = xe32[e + 4];
      a[mt][s][3] = xo32[e + 4];
    }
}

// The products of one n8 tile: acc[mt][i] += the two k16 steps in order
// s = 0, 1, for each m-tile.
__device__ __forceinline__ void tile_products(const uint32_t (&a)[2][2][4],
                                              const uint32_t (&b)[2][2], float (&acc)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    mma_bf16(acc[0], a[0][s], b[s][0], b[s][1]);
    mma_bf16(acc[1], a[1][s], b[s][0], b[s][1]);
  }
}

// The conv sums of pooled position lp for the slice of bw, every n8 tile
// from zero: acc[mt][nt][i], the tiles in order nt = 0..3. Each
// accumulator's sum is the chain of tile_products whether a kernel takes
// the tiles here at once or one by one, so both give the same sums bit for
// bit.
__device__ __forceinline__ void unit_products(const uint32_t* xe32, const uint32_t* xo32, int lp,
                                              int tq, const uint32_t (&bw)[4][2][2],
                                              float (&acc)[2][4][4]) {
  uint32_t a[2][2][4];
  load_a_fragments(xe32, xo32, lp, tq, a);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float t[2][4] = {};
    tile_products(a, bw[nt], t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = t[mt][i];
  }
}

}  // namespace
}  // namespace vm_block0
