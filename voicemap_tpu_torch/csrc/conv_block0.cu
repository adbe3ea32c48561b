// B2: the encoder's block 0 fused: SAME conv (Cin=1, k=32) + bias -> relu ->
// BatchNorm inference affine -> max-pool 4, writing only the pool-rate output.
//
// Replaces voicemap_tpu/ops/pallas_conv.py :: _kernel (wrapper
// pallas_conv_block0). For row b, pooled position p and channel c:
//   y_j   = sum_k x[4p + j + k - 15] * w[k, c]     (x = 0 outside [0, T))
//   out   = max_j ( relu(y_j + bias[c]) * mul[c] + add[c] ),  j = 0..3
// mul = gamma * rsqrt(var + eps) and add = beta - mean * mul come from the
// wrapper in f32. The affine is applied before the max: mul can be negative.
// x and w arrive rounded to the GEMM dtype (bf16 on the main path); products
// are summed in f32 in tap order k = 0..31, the epilogue is f32 op by op, and
// the output is rounded once, at the store: to f32, to bf16, or, on the int8
// serving path, requantized from the f32 pooled value as
//   q = clamp(round_half_even(out * inv_s0[c]), -127, 127)
// (pallas_conv.py's requant epilogue; inv_s0 = 1 / s0 from the wrapper, a
// multiply by the reciprocal as there, not a division). A tail of
// T % 4 samples is dropped (floor pooling); the conv still sees it as input.
//
// What bounds it on the H100: FLOPs. At B=2048, T=12000, C=128 the conv is
// about 201 GFLOP against a 1.57 GB bf16 output, and these FMAs run on the
// CUDA cores (int8 output: 201 GFLOP against 0.79 GB). Design: one CTA per
// (row, tile of kTile pooled outputs), one thread per channel. The tile's
// input window (4 * kTile + 31 samples) sits
// in shared memory and every thread of a warp reads the same sample, a
// broadcast without bank conflicts; each thread keeps its channel's 32 taps
// in registers and its 4 phases' sums in registers, so the full-rate
// activation never leaves the SM. Stores are channel-contiguous. Moving the
// conv onto the tensor cores (mma / wgmma over a pooled-frame GEMM) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;  // pooled outputs per CTA

enum OutKind { kF32 = 0, kBF16 = 1, kInt8 = 2 };

template <int K, int POOL, int OUT>
__global__ void conv_block0_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ aff,
                                   const float* __restrict__ inv_s0,
                                   void* __restrict__ out, int T, int C,
                                   int round_x) {
  constexpr int kPadL = (K - 1) / 2;
  constexpr int kWin = POOL * kTile + K - 1;
  __shared__ float xs[kWin];

  const int b = blockIdx.y;
  const int t_out = T / POOL;
  const int p0 = blockIdx.x * kTile;
  const long long t0 = (long long)p0 * POOL - kPadL;
  const float* xrow = x + (long long)b * T;
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) {
    const long long t = t0 + i;
    float v = (t >= 0 && t < T) ? xrow[t] : 0.f;
    if (round_x) v = __bfloat162float(__float2bfloat16(v));
    xs[i] = v;
  }
  __syncthreads();

  const int n_p = min(kTile, t_out - p0);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float wr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wr[k] = w[k * C + c];
    const float bias = aff[c], mul = aff[C + c], add = aff[2 * C + c];
    const float inv = OUT == kInt8 ? inv_s0[c] : 0.f;
    const long long obase = ((long long)b * t_out + p0) * C + c;
    for (int p = 0; p < n_p; ++p) {
      float xr[POOL + K - 1];
#pragma unroll
      for (int i = 0; i < POOL + K - 1; ++i) xr[i] = xs[p * POOL + i];
      float best = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < POOL; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(xr[j + k], wr[k], acc);
        // Rounded op by op, never contracted into an FMA, so the epilogue
        // matches the plain version's bit for bit.
        const float h = __fmul_rn(fmaxf(__fadd_rn(acc, bias), 0.f), mul);
        best = fmaxf(best, __fadd_rn(h, add));
      }
      const long long o = obase + (long long)p * C;
      if (OUT == kInt8) {
        // Half to even, as jnp.round; roundf would round halves away.
        const int q = __float2int_rn(__fmul_rn(best, inv));
        static_cast<int8_t*>(out)[o] = (int8_t)min(max(q, -127), 127);
      } else if (OUT == kBF16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(best);
      } else {
        static_cast<float*>(out)[o] = best;
      }
    }
  }
}

}  // namespace

// inv_s0: NULL, or the (C,) f32 reciprocal requant scales, which make the
// output int8 (out_bf16 is then not read).
extern "C" int vm_conv_block0(const void* x, const void* w, const void* aff,
                              const void* inv_s0, void* out, int B, int T,
                              int C, int K, int pool, int round_x,
                              int out_bf16, void* stream) {
  if (K != 32 || pool != 4) return (int)cudaErrorInvalidValue;
  const int t_out = T / pool;
  if (B == 0 || t_out == 0) return 0;
  const dim3 grid((t_out + kTile - 1) / kTile, B);
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* af = (const float*)aff;
  const float* inv = (const float*)inv_s0;
  if (inv)
    conv_block0_kernel<32, 4, kInt8><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                              round_x);
  else if (out_bf16)
    conv_block0_kernel<32, 4, kBF16><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                              round_x);
  else
    conv_block0_kernel<32, 4, kF32><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                             round_x);
  return (int)cudaGetLastError();
}
