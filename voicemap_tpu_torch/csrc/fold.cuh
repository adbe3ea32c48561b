// Deterministic fold of per-CTA partial rows, shared by the train kernels.
//
// A kernel whose CTAs each produce a row of partial sums writes them to
// part[rows][width]; fold_rows sums each column over the rows in a fixed
// order (thread y of 8 takes rows y, y+8, ..., then the 8 sums are added in
// order y = 0..7), so a result repeats bit for bit from run to run, unlike a
// fold by atomics.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each translation unit that includes this has its own copy.
namespace vm_fold {
namespace {

constexpr int kCols = 32;
constexpr int kSplit = 8;

__global__ void __launch_bounds__(kCols * kSplit)
fold_rows_kernel(const float* __restrict__ part, int rows, int width,
                 float* __restrict__ out) {
  __shared__ float red[kSplit][kCols + 1];
  const int col = blockIdx.x * kCols + threadIdx.x;
  float s = 0.f;
  if (col < width)
    for (int r = threadIdx.y; r < rows; r += kSplit)
      s = __fadd_rn(s, part[(long long)r * width + col]);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = red[0][threadIdx.x];
    for (int i = 1; i < kSplit; ++i) t = __fadd_rn(t, red[i][threadIdx.x]);
    out[col] = t;
  }
}

inline void fold_rows(const float* part, int rows, int width, float* out,
                      cudaStream_t s) {
  const dim3 block(kCols, kSplit);
  fold_rows_kernel<<<(width + kCols - 1) / kCols, block, 0, s>>>(part, rows, width, out);
}

}  // namespace
}  // namespace vm_fold
