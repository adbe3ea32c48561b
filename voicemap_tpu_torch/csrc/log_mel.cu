// B6: fused framing + windowed DFT + power + mel + log, one pass over the
// waveform.
//
// Replaces voicemap_tpu/ops/pallas_melspec.py :: _fused_kernel and
// _preframed_kernel (core _dft_mel; wrapper pallas_log_mel). It computes the
// wrapper's function, not its blocks:
//   out[b, f, m] = log(sum_k ((F·C)[f,k]^2 + (F·S)[f,k]^2) · fb[k, m] + eps)
// where frame f is x[b, f·hop .. f·hop + win), C and S are the Hann-windowed
// cos and -sin bases of melspec.dft_bases (win, K = n_fft/2 + 1) and fb the
// Slaney mel filterbank (K, M). f32 in, f32 out.
//
// What bounds the function on the H100: bytes. At config #4 (B=2048,
// T=48000, hop 128, win 384, K 257, M 64; 373 frames) it reads 393 MB and
// writes 196 MB, 0.18 ms at the H100 SXM's published 3.35 TB/s; by the rfft
// route it needs 10.5 GFLOP (a 512-point real FFT, power, mel bands, log),
// 0.16 ms even at the f32 CUDA-core rate. This kernel's algorithm, the DFT
// as a matmul, does 302 GFLOP instead: 0.61 ms at the TF32 tensor-core rate,
// 4.5 ms at the f32 CUDA-core rate (published peaks, 700 W). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 11.2 ms (PERF.md).
//
// Design, simple first: f32 FMAs on the CUDA cores (TF32 keeps about three
// digits, as much error on the power as the 1e-3 the log-mel is held to).
// One CTA owns one row and a tile of 64 frames:
// - it stages the waveform span of its frames in shared memory, read once
//   from device memory (33 KB at hop 128, win 384), so the frames are never
//   materialised and any hop, any win <= n_fft and any T >= win are taken;
// - the interleaved bases [C row | S row] (K padded with zero columns to
//   288) stream through shared memory in slabs of 16 window rows, double
//   buffered with cp.async; L2 holds the 885 KB of bases for every CTA;
// - each of the 8 warps owns 8 frames, each lane 9 frequency columns
//   (lane + 32j), so a thread keeps 8 x 9 re and 8 x 9 im sums in registers
//   and every x value is a shared-memory broadcast;
// - the (64 x 288) power tile then lands in shared memory over the spent
//   slabs, and the mel product walks each filter's nonzero band of bins
//   only (the wrapper passes the bands; zeros outside them add nothing),
//   followed by log. Neither frames nor power reach device memory.
// The sum orders are the kernel's own (window rows in order, each band in
// order); no bit-exactness with the plain version is claimed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kFrameTile = kWarps * kFramesPerWarp;  // 64 frames a CTA
constexpr int kCols = 9;                              // columns a lane
constexpr int kKPad = 32 * kCols;                     // 288 >= K
constexpr int kSlabRows = 16;                         // window rows a slab
constexpr int kSlabFloats = kSlabRows * 2 * kKPad;
constexpr int kTileFloats = 2 * kSlabFloats;          // two slabs, or the power tile
static_assert(kFrameTile * kKPad <= kTileFloats, "the power tile must fit over the slabs");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [n0, n0 + rows) of the interleaved bases into a slab buffer.
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ cs, int n0,
                                          int rows) {
  const float* src = cs + (long long)n0 * 2 * kKPad;
  const int n4 = rows * 2 * kKPad / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
log_mel_kernel(const float* __restrict__ x, const float* __restrict__ cs,
               const float* __restrict__ fbt, const int32_t* __restrict__ bands,
               float* __restrict__ out, int T, int n_frames, int n_tiles, int win, int hop,
               int M, int K, float log_eps) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                 // two basis slabs, later the power tile
  float* xs = smem + kTileFloats;     // the waveform span of the frame tile

  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * kFrameTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_slabs = (win + kSlabRows - 1) / kSlabRows;

  load_slab(tile, cs, 0, min(kSlabRows, win));

  // The span read once; samples past the row (frames past n_frames) are 0.
  const float* row = x + (long long)b * T;
  const long long start = (long long)f0 * hop;
  const int span = (kFrameTile - 1) * hop + win;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long p = start + i;
    xs[i] = p < T ? row[p] : 0.f;
  }

  float re[kFramesPerWarp][kCols], im[kFramesPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) re[i][j] = im[i][j] = 0.f;

  const float* xw = xs + warp * kFramesPerWarp * hop;
  for (int s = 0; s < n_slabs; ++s) {
    const int n0 = s * kSlabRows;
    if (s + 1 < n_slabs) {
      load_slab(tile + ((s + 1) & 1) * kSlabFloats, cs, n0 + kSlabRows,
                min(kSlabRows, win - n0 - kSlabRows));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* slab = tile + (s & 1) * kSlabFloats + lane;
    const int rows = min(kSlabRows, win - n0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float xv[kFramesPerWarp], cv[kCols], sv[kCols];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) xv[i] = xw[i * hop + n0 + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        cv[j] = slab[r * 2 * kKPad + 32 * j];
        sv[j] = slab[r * 2 * kKPad + kKPad + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
          im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
        }
    }
    __syncthreads();  // the next iteration refills the buffer read here
  }

  // Power over the spent slabs: re^2 + im^2, rounded op by op as the plain
  // version computes it.
  float* power = tile;
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      power[(warp * kFramesPerWarp + i) * kKPad + lane + 32 * j] =
          __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
  __syncthreads();

  // Mel over each filter's band of nonzero bins, then log; the tile's rows
  // are contiguous in the output, so consecutive threads store consecutively.
  const int valid = min(kFrameTile, n_frames - f0);
  float* dst = out + ((long long)b * n_frames + f0) * M;
  for (int idx = threadIdx.x; idx < valid * M; idx += kThreads) {
    const int f = idx / M, m = idx - f * M;
    const int lo = bands[m], hi = bands[M + m];
    const float* p = power + f * kKPad;
    const float* w = fbt + (long long)m * K;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(p[k], __ldg(w + k), acc);
    dst[idx] = logf(acc + log_eps);
  }
}

}  // namespace

// x (B, T) f32; cs (win, 2, 288) f32, [C row | S row] with zero columns past
// K; fbt (M, K) f32, the filterbank transposed; bands (2, M) int32, each
// filter's first and one-past-last nonzero bin; out (B, n_frames, M) f32.
// K > 288, or a hop and win whose waveform span does not fit a CTA's shared
// memory next to the slabs, returns cudaErrorInvalidValue and launches nothing.
extern "C" int vm_log_mel(const void* x, const void* cs, const void* fbt, const void* bands,
                          void* out, int B, int T, int n_frames, int win, int hop, int M,
                          int K, float log_eps, void* stream) {
  if (B == 0 || n_frames <= 0) return 0;
  if (K > kKPad) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_frames + kFrameTile - 1) / kFrameTile;
  const size_t smem = (size_t)(kTileFloats + (kFrameTile - 1) * hop + win) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_kernel<<<(unsigned)B * n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)cs, (const float*)fbt, (const int32_t*)bands,
      (float*)out, T, n_frames, n_tiles, win, hop, M, K, log_eps);
  return (int)cudaGetLastError();
}
