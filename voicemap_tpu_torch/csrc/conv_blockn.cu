// B8: a bf16 encoder block 1+ fused: SAME conv (k odd, dilation d) + bias ->
// relu -> BatchNorm inference affine -> max-pool 2 (or none: pool 1),
// writing only the pool-rate output.
//
// Replaces voicemap_tpu/ops/pallas_conv.py :: _kernel_chan (wrapper
// pallas_conv_blockn) and _kernel_chan_streamed (wrapper
// pallas_conv_blockn_streamed). The two TPU kernels compute the same
// function; the streamed one only changes when the input is copied in. Their
// pair-merged input and phase-stacked (k+1)*Cin x 2*Cout weights kept Mosaic's
// slices lane-aligned at the cost of 4/3 of the conv's multiply-adds; this
// kernel does the direct conv. For row b, time t and output channel c
// (x = 0 outside [0, T), h = d * (k - 1) / 2):
//   y[t]   = sum_{j, ci} x[t + j * d - h, ci] * w[j, ci, c]    in f32
//   z[t]   = relu(y[t] + bias[c]) * mul[c] + add[c]             in f32
//   out[u] = max(z[2u], z[2u + 1]) at pool 2, z[u] at pool 1, rounded once
//            to bf16 (or kept in f32)
// The TPU kernels take dilation 1 and pool 2 only; the JAX package sends its
// dilated and pool-1 blocks (config #3's) to XLA's conv
// (voicemap_tpu/models/fast_infer.py :: _xla_block), which this kernel
// computes too.
// mul = gamma * rsqrt(var + eps) and add = beta - mean * mul come from the
// wrapper in f32; the affine comes before the max because mul can be
// negative. x and w are bf16, so every product is exact in f32; the tensor
// cores' order of the f32 sums is theirs, so the result agrees with the
// plain version (ops/cuda_conv.py :: conv_blockn_reference) to a bound, not
// bit for bit. The epilogue is rounded op by op (__fadd_rn, __fmul_rn), so
// nvcc cannot contract it into an FMA. An odd T at pool 2 drops its last step
// from the pool; the conv still reads it.
//
// What bounds it on the H100: operations. At config #1 and B=2048, blocks
// 1-3 (128 -> 256 at T 3000, 256 -> 384 at 1500, 384 -> 512 at 750) are
// 1.21, 1.81 and 1.81 TFLOP of direct conv: 1.22, 1.83 and 1.83 ms at the
// 989 TFLOP/s bf16 tensor-core peak, above their bytes (3.15, 2.75, 1.97 GB
// with the bf16 output: 0.94, 0.82, 0.59 ms at 3.35 TB/s).
//
// Design (conv_sm90.cuh, shared with B3): the implicit GEMM M = time, N =
// Cout, K = k * Cin on wgmma.mma_async.m64n128k16 bf16 -> f32, both operands
// loaded by TMA into a ring of stages, a producer warp, two consumer
// warpgroups and three writer warps, a persistent grid of one CTA an SM,
// tiles of 256 conv rows x 128 channels. Against the first design
// (warp-level m16n8k16 products with 32-bit shared loads, one CTA per
// 128-row tile):
// - fragment traffic: wgmma reads both operands from shared memory itself,
//   a 64 x 128 product per instruction, where each warp loaded 2 KB of
//   fragments for 8 mma of 16 x 8;
// - weight re-streaming: each weight byte a CTA pulls from L2 serves 256
//   rows, and each input byte all k taps (a tap is a 64-byte move of the A
//   descriptor, not a copy); a stage is 41 KB for 6.3 MFLOP, where the first
//   design pulled its whole (Cout, k * Cin) weight matrix for every 128 rows;
// - occupancy and synchronisation: no __syncthreads in the loop; mbarriers
//   hand each stage from the producer to the consumers and back, the ring (3
//   or 4 stages at k = 3) keeps loads in flight under the products, and the
//   writers overlap the stores of one tile with the products of the next.
// The epilogue pools first: of each pair it keeps the max where mul > 0 and
// the min elsewhere, then applies the affine once (at pool 1 the pair is a
// row's value with itself, so there is nothing to select). Every op of the affine is
// monotone in y (nondecreasing for mul > 0, nonincreasing for mul < 0,
// constant for mul = 0), so this is the affine-then-max above, bit for bit.
// The weights come packed (Cout, k * Kp), each tap's Cin padded with zeros
// to Kp, a multiple of 64 (ops/conv_sm90.py :: pack_taps): a Cin of 40 reads
// zero weights and TMA's zero fill past Cin, never the next tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_sm90.cuh"

namespace {

enum OutKind { kBF16 = 1, kF32 = 2 };
template <int OUT>
constexpr int kOutBytes = OUT == kBF16 ? 2 : 4;

// relu(y + bias) * mul + add, rounded op by op.
__device__ __forceinline__ float affine(float y, float bias, float mul, float add) {
  return __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(y, bias), 0.f), mul), add);
}

// x: (B, T, Cin) bf16 through mx; w: (Cout, k * Kp) bf16 through mw; aff:
// (3, Cout) f32 rows bias, mul, add; out: (B, T / pool, Cout).
template <int MW, int OUT>
__global__ void __launch_bounds__(sm90conv::kThreads, 1)
conv_blockn_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const sm90conv::Problem p, const float* __restrict__ aff,
                   void* __restrict__ out) {
  using V2 = std::conditional_t<OUT == kBF16, __nv_bfloat162, float2>;
  sm90conv::run<MW, float, V2>(
      &mx, &mw, p, aff,
      // The pair's max after the affine is the affine of the pair's max
      // where mul > 0 and of its min elsewhere: each op of the affine is
      // monotone in y, nondecreasing for mul > 0 and nonincreasing for mul <
      // 0 (constant for mul = 0), so the pooled value is the same bit for bit.
      [&](uint32_t a, int col, float lo0, float lo1, float hi0, float hi1) {
        constexpr int N = sm90conv::kTileN;
        const float2 bias = sm90conv::rows_at(a + 4 * col);
        const float2 mul = sm90conv::rows_at(a + 4 * (N + col));
        const float2 add = sm90conv::rows_at(a + 4 * (2 * N + col));
        const float z0 = affine(mul.x > 0.f ? fmaxf(lo0, hi0) : fminf(lo0, hi0), bias.x, mul.x,
                                add.x);
        const float z1 = affine(mul.y > 0.f ? fmaxf(lo1, hi1) : fminf(lo1, hi1), bias.y, mul.y,
                                add.y);
        if constexpr (OUT == kBF16) {
          return __floats2bfloat162_rn(z0, z1);
        } else {
          return make_float2(z0, z1);
        }
      },
      out);
}

template <int MW, int OUT>
cudaError_t launch_tiles(const void* x, const void* w, const void* aff, void* out, int B, int T,
                         int Cin, int Cout, int k, int d, int pool, int sms, cudaStream_t s) {
  constexpr int ob = kOutBytes<OUT>;
  sm90conv::Problem p;
  CUtensorMap mx, mw;
  cudaError_t err =
      sm90conv::make_problem<MW, ob>(&p, &mx, &mw, x, w, B, T, Cin, Cout, k, d, pool, 2);
  if (err != cudaSuccess) return err;
  return sm90conv::launch<MW, ob>(conv_blockn_kernel<MW, OUT>, mx, mw, p, sms, s,
                                  (const float*)aff, out);
}

template <int OUT>
cudaError_t launch(const void* x, const void* w, const void* aff, void* out, int B, int T,
                   int Cin, int Cout, int k, int d, int pool, cudaStream_t s) {
  const int sms = sm90conv::sm_count();
  if (sms == 0) return cudaErrorNoDevice;
  if (sm90conv::wide_tiles<kOutBytes<OUT>>(B, T, Cout, k, d, pool, sms))
    return launch_tiles<2, OUT>(x, w, aff, out, B, T, Cin, Cout, k, d, pool, sms, s);
  return launch_tiles<1, OUT>(x, w, aff, out, B, T, Cin, Cout, k, d, pool, sms, s);
}

}  // namespace

// out_kind: 1 bf16, 2 f32. w is (Cout, k * Kp) bf16, tap j's K run at
// [j * Kp, j * Kp + Cin) and zeros up to Kp = Cin rounded up to 64. k odd
// and at most kMaxK = 9, the reach d * (k - 1) at most kMaxReach = 128 (one
// TMA box of 128 + reach rows), pool 1 or 2, Cin a multiple of 8 (TMA's
// 16-byte row stride); x and w 16-byte aligned. Returns
// cudaErrorInvalidValue, launching nothing, for anything else.
extern "C" int vm_conv_blockn(const void* x, const void* w, const void* aff, void* out, int B,
                              int T, int Cin, int Cout, int k, int d, int pool, int out_kind,
                              void* stream) {
  if (Cin <= 0 || Cin % 8 != 0 || k < 1 || k % 2 == 0 || d < 1 || (pool != 1 && pool != 2) ||
      sm90conv::Tile<1, 4>::stages(k, d * (k - 1), pool) < 1 ||
      (out_kind != kBF16 && out_kind != kF32))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < pool || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kBF16)
    return (int)launch<kBF16>(x, w, aff, out, B, T, Cin, Cout, k, d, pool, s);
  return (int)launch<kF32>(x, w, aff, out, B, T, Cin, Cout, k, d, pool, s);
}
