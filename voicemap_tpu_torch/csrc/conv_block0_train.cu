// B4 and B5: the encoder's block 0 in training, forward and backward, with
// the full-rate activation kept on the SM in both directions.
//
// Replaces voicemap_tpu/ops/pallas_conv_train.py :: _fwd_kernel (B4, wrapper
// pallas_fwd_core) and _bwd_kernel (B5, wrapper pallas_bwd_core). For row b,
// pooled position p, phase j = 0..3 and channel c, both recompute
//   a_j = relu( sum_k x[4p + j + k - 15] * w[k, c]  +  bias[c] )
// (x = 0 outside [0, T)), with x and w rounded to the GEMM dtype by the
// wrapper or on load, the taps summed in order k = 0..31 in f32 and the bias
// added after, as the plain versions do, so both kernels see the same a_j
// bit for bit and agree with the plain versions on which phase is maximal.
//
// B4 writes a_sel[b, p, c] = s * max_j(s * a_j), s = sign(gamma[c]) (the
// value BatchNorm's monotone affine makes the max-pool pick), rounded once
// to the selection dtype, and the per-channel sums (sum a, sum a^2,
// #(a > 0)) over every full-rate position.
// B5 routes the pooled cotangent g[b, p, c] (rounded to the GEMM dtype by
// the wrapper) to the first phase in time order with s * a_j equal to the
// max, forms dz_j = a_j > 0 ? (c0*g_j + c1) + c2*a_j : 0 in f32 op by op,
// sums dz_j into db in f32, rounds dz_j to the GEMM dtype and accumulates
// dW[k, c] += x[4p + j + k - 15] * dz_j.
//
// What bounds them on the H100: at B=32, T=12000, C=128 each conv is
// 3.1 GFLOP against ~26 MB (B4: x read, a_sel written; B5: x and g read),
// 8 us of bytes and 3 us at the bf16 tensor rate; these FMAs run on the CUDA
// cores (67 TFLOP/s f32), so operations bound them, ~50 us each for the
// conv, B5 twice that (the recompute and the dW product). Design: B2's
// direct convolution, one thread per channel with its 32 taps (B5: and its
// 32 dW sums) in registers, the input window of a tile of 128 pooled
// outputs staged in shared memory and read as a broadcast. The TPU summed
// its statistics and dW over a sequential grid; here the grid is a fixed
// number of CTAs that each walk a fixed set of tiles, write one row of
// partial sums, and a second small kernel folds the rows in a fixed order
// (fold.cuh): no atomics, so the sums repeat run to run. Tensor-core
// versions (a pooled-frame GEMM) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

constexpr int kTile = 128;  // pooled outputs per tile
constexpr int kK = 32;      // taps
constexpr int kPool = 4;
constexpr int kPadL = (kK - 1) / 2;  // XLA's SAME for even k: 15 left, 16 right
constexpr int kWin = kPool * kTile + kK - 1;
constexpr int kFwdVals = 3;       // sum a, sum a^2, #(a > 0)
constexpr int kBwdVals = kK + 1;  // dW rows, then db
constexpr int kMaxThreads = 256;  // one thread per channel: C <= 256

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc + x * w. With bf16-rounded operands the product is exact in f32, so
// one FMA equals the plain version's multiply-then-add; in f32 the two
// roundings are kept apart to match it.
template <bool BF16>
__device__ __forceinline__ float tap(float acc, float x, float w) {
  return BF16 ? fmaf(x, w, acc) : __fadd_rn(acc, __fmul_rn(x, w));
}

// Stage the tile's input window, rounded to the GEMM dtype.
template <bool BF16>
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ xrow,
                                      long long t0, int T) {
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) {
    const long long t = t0 + i;
    const float v = (t >= 0 && t < T) ? xrow[t] : 0.f;
    xs[i] = BF16 ? round_bf16(v) : v;
  }
}

// The four phases' relu activations of pooled position p.
template <bool BF16>
__device__ __forceinline__ void phases(const float* xs, int p, const float (&wr)[kK],
                                       float bias, float (&a)[kPool]) {
  float xr[kPool + kK - 1];
#pragma unroll
  for (int i = 0; i < kPool + kK - 1; ++i) xr[i] = xs[p * kPool + i];
#pragma unroll
  for (int j = 0; j < kPool; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) acc = tap<BF16>(acc, xr[j + k], wr[k]);
    a[j] = fmaxf(__fadd_rn(acc, bias), 0.f);
  }
}

template <bool BF16, bool SEL_BF16>
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
    stage<BF16>(xs, x + (long long)b * T, (long long)p0 * kPool - kPadL, T);
    __syncthreads();
    if (!live) continue;
    const int n_p = min(kTile, t_out - p0);
    for (int p = 0; p < n_p; ++p) {
      float a[kPool];
      phases<BF16>(xs, p, wr, bc, a);
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

template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
block0_train_bwd(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ sgn,
                 const void* __restrict__ g, const float* __restrict__ cc,
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
    stage<BF16>(xs, x + (long long)b * T, (long long)p0 * kPool - kPadL, T);
    __syncthreads();
    if (!live) continue;
    const int n_p = min(kTile, t_out - p0);
    for (int p = 0; p < n_p; ++p) {
      float a[kPool];
      phases<BF16>(xs, p, wr, bc, a);
      float best = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < kPool; ++j) best = fmaxf(best, __fmul_rn(a[j], sc));
      const long long o = ((long long)b * t_out + p0 + p) * C + c;
      const float gv = BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[o])
                            : static_cast<const float*>(g)[o];
      bool taken = false;
#pragma unroll
      for (int j = 0; j < kPool; ++j) {
        const bool eq = !taken && __fmul_rn(a[j], sc) == best;
        taken = taken || eq;
        const float gj = eq ? gv : 0.f;
        const float dz = a[j] > 0.f
            ? __fadd_rn(__fadd_rn(__fmul_rn(c0, gj), c1), __fmul_rn(c2, a[j])) : 0.f;
        db = __fadd_rn(db, dz);
        const float dzr = BF16 ? round_bf16(dz) : dz;
#pragma unroll
        for (int k = 0; k < kK; ++k) dw[k] = tap<BF16>(dw[k], xs[p * kPool + j + k], dzr);
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

}  // namespace

// x (B, T) f32; w (32, C) f32 rounded to the GEMM dtype; bias, sgn (C,) f32;
// sel (B, T/4, C) f32 or bf16; part (n_ctas, 3, C) f32 scratch;
// stats (3, C) f32 out.
extern "C" int vm_block0_train_fwd(const void* x, const void* w, const void* bias,
                                   const void* sgn, void* sel, void* part, void* stats,
                                   int B, int T, int C, int n_ctas, int gemm_bf16,
                                   int sel_bf16, void* stream) {
  if (int err = check_shape(B, T, C, n_ctas)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((C + 31) / 32) * 32;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)bias,
              *sf = (const float*)sgn;
  float* pf = (float*)part;
  if (gemm_bf16 && sel_bf16)
    block0_train_fwd<true, true><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  else if (gemm_bf16)
    block0_train_fwd<true, false><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  else if (sel_bf16)
    block0_train_fwd<false, true><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  else
    block0_train_fwd<false, false><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, sel, pf, B, T, C);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, n_ctas, kFwdVals * C, (float*)stats, s);
  return (int)cudaGetLastError();
}

// g (B, T/4, C) in the GEMM dtype; cc (3, C) f32: c0, c1, c2;
// part (n_ctas, 33, C) f32 scratch; out (33, C) f32: dW rows k = 0..31, db.
extern "C" int vm_block0_train_bwd(const void* x, const void* w, const void* bias,
                                   const void* sgn, const void* g, const void* cc,
                                   void* part, void* out, int B, int T, int C, int n_ctas,
                                   int gemm_bf16, void* stream) {
  if (int err = check_shape(B, T, C, n_ctas)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((C + 31) / 32) * 32;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)bias,
              *sf = (const float*)sgn, *cf = (const float*)cc;
  float* pf = (float*)part;
  if (gemm_bf16)
    block0_train_bwd<true><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, g, cf, pf, B, T, C);
  else
    block0_train_bwd<false><<<n_ctas, threads, 0, s>>>(xf, wf, bf, sf, g, cf, pf, B, T, C);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, n_ctas, kBwdVals * C, (float*)out, s);
  return (int)cudaGetLastError();
}
