// B1: fused fragment gather + whiten over a pre-decimated int16 store.
//
// Replaces voicemap_tpu/ops/pallas_preprocess.py :: _gather_whiten_kernel
// (wrapper pallas_gather_whiten). Per output row b:
//   x[i]   = store[idx[b], off[b] + i] / 32768   for i < frag, 0 outside the row
//   out[i] = (x[i] - mean) * (rms / (sqrt(mean((x - mean)^2)) + eps))
// with both statistics over the frag true samples (two passes, as
// _whiten_cols computes them).
//
// What bounds it on the H100: bytes. At B=2048, frag=12000 it reads 49 MB of
// int16 and writes 98 MB of f32, about 147 MB, against a few FLOPs a sample.
// Design: one CTA per row reads the row's samples from device memory once,
// into shared memory (24 KB at frag=12000), so both statistics passes and the
// write run from shared memory; device memory sees one read and one write of
// each sample. The mean is taken from an exact integer sum. Any offset and
// any batch size are taken; there is no alignment padding or row padding.
// Vectorised 16-byte loads and stores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInt16Scale = 1.0f / 32768.0f;

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();  // scratch may be reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
gather_whiten_kernel(const int16_t* __restrict__ store, long long n_rows,
                     long long row_len, const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ off, float* __restrict__ out,
                     int frag, float rms, float eps, int whiten) {
  extern __shared__ int16_t samples[];  // frag values
  __shared__ long long isum[kThreads / 32];
  __shared__ float fsum[kThreads / 32];

  const int b = blockIdx.x;
  const long long row = idx[b];
  float* dst = out + (long long)b * frag;
  if (row < 0 || row >= n_rows) {
    // An index outside the store has no samples: the row is NaN, never a
    // read outside the allocation.
    for (int i = threadIdx.x; i < frag; i += kThreads) dst[i] = __int_as_float(0x7fc00000);
    return;
  }
  const int16_t* src = store + row * row_len;
  const long long start = off[b];

  long long s = 0;
  for (int i = threadIdx.x; i < frag; i += kThreads) {
    const long long p = start + i;
    const int16_t v = (p >= 0 && p < row_len) ? src[p] : (int16_t)0;
    samples[i] = v;
    s += v;
  }
  if (!whiten) {
    for (int i = threadIdx.x; i < frag; i += kThreads)
      dst[i] = (float)samples[i] * kInt16Scale;
    return;
  }
  const float mean = (float)((double)block_sum(s, isum) / frag) * kInt16Scale;

  float q = 0.f;
  for (int i = threadIdx.x; i < frag; i += kThreads) {
    const float c = (float)samples[i] * kInt16Scale - mean;
    q = fmaf(c, c, q);
  }
  const float cur = sqrtf(block_sum(q, fsum) / (float)frag);
  const float scale = rms / (cur + eps);
  for (int i = threadIdx.x; i < frag; i += kThreads)
    dst[i] = ((float)samples[i] * kInt16Scale - mean) * scale;
}

}  // namespace

extern "C" int vm_gather_whiten(const void* store, long long n_rows,
                                long long row_len, const void* idx,
                                const void* off, void* out, int B, int frag,
                                float rms, float eps, int whiten,
                                void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)frag * sizeof(int16_t);
  cudaError_t err = cudaFuncSetAttribute(
      gather_whiten_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_whiten_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int16_t*)store, n_rows, row_len, (const int32_t*)idx,
      (const int32_t*)off, (float*)out, frag, rms, eps, whiten);
  return (int)cudaGetLastError();
}

extern "C" const char* vm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
