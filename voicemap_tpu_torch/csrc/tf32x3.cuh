// 3xTF32: an f32 matrix product on the tensor cores that keeps almost all of
// f32's precision. Shared by B6's DFT route (log_mel.cu :: log_mel_tc_kernel,
// on wgmma with A from registers) and B4's and B5's f32 route
// (conv_block0_train.cu :: block0_train_tc32: the conv on wgmma, A from
// registers; B5's weight gradient on mma.sync.m16n8k8).
//
// TF32 alone keeps 10 mantissa bits, about three digits. Split each operand
// a = big + small, big = tf32(a) (cvt.rna: round to nearest on the f32 bit
// pattern, ties away from zero), small = tf32(a - big) (a - big is exact in
// f32); then a·b is taken as small_a·big_b + big_a·small_b + big_a·big_b,
// each an exact f32 product of two tf32 values, accumulated in f32, the
// small terms first. What it drops, small_a·small_b and the roundings of
// the two smalls, is each at most 2^-22 of |a·b| (|small| <= 2^-11·|a|, its
// rounding <= 2^-11·|small|), so at most 3·2^-22, about 2^-21: the error of
// an f32 sum of a few products (CUTLASS's OpMultiplyAddFastF32 does the
// same). ops/tf32x3.py is the plain model of the split and of the sum;
// ops/block0_train_tc.tf32x3_unit carries this account into an order bound.
//
// Fragments of m16n8k8 (g = lane / 4, tq = lane % 4):
//   A (16 x 8, row major): a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4),
//                          a3 (g + 8, tq + 4);
//   B (8 x 8, column):     b0 (k = tq, n = g), b1 (k = tq + 4, n = g);
//   C (16 x 8):            c0, c1 (g, 2tq and 2tq + 1), c2, c3 (g + 8, ...).
// wgmma's A from registers takes each warp's 16 rows of its m64 tile in the
// same layout. The loads read a view of shared memory in which element (r,
// c) lies at base[row offset of r + column offset of c], so a kernel hands
// each lane the two offsets it needs along each axis: a strided matrix, a
// Toeplitz view of a window (B5's X[k][t] = x[t + k]), or a frame view of a
// staged waveform (B6's row f at f·hop).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage: each translation unit that includes this has its own copy.
namespace vm_tf32x3 {
namespace {

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a · b, tf32 operands, f32 accumulator. Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's fragment, split on the load: rows g and g + 8 at row offsets r0 and
// r1, columns tq and tq + 4 at column offsets c0 and c1.
__device__ __forceinline__ void load_a(FragA& a, const float* base, int r0, int r1, int c0,
                                       int c1) {
  split(base[r0 + c0], a.big[0], a.small[0]);
  split(base[r1 + c0], a.big[1], a.small[1]);
  split(base[r0 + c1], a.big[2], a.small[2]);
  split(base[r1 + c1], a.big[3], a.small[3]);
}

// B's fragment, split on the load: rows k = tq and tq + 4 at row offsets k0
// and k1, column g at column offset n.
__device__ __forceinline__ void load_b(FragB& b, const float* base, int k0, int k1, int n) {
  split(base[k0 + n], b.big[0], b.small[0]);
  split(base[k1 + n], b.big[1], b.small[1]);
}

// The same fragments from a view split once beforehand: each element a
// (big, small) pair, one 64-bit load.
__device__ __forceinline__ uint2 split2(float x) {
  uint2 r;
  split(x, r.x, r.y);
  return r;
}
__device__ __forceinline__ void load_a(FragA& a, const uint2* base, int r0, int r1, int c0,
                                       int c1) {
  const uint2 v[4] = {base[r0 + c0], base[r1 + c0], base[r0 + c1], base[r1 + c1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) a.big[i] = v[i].x, a.small[i] = v[i].y;
}
__device__ __forceinline__ void load_b(FragB& b, const uint2* base, int k0, int k1, int n) {
  const uint2 v0 = base[k0 + n], v1 = base[k1 + n];
  b.big[0] = v0.x, b.small[0] = v0.y;
  b.big[1] = v1.x, b.small[1] = v1.y;
}

// ---------------------------------------------------------------------------
// The warpgroup form (wgmma), A from registers: B6's DFT route (N = 208) and
// B4's and B5's f32 conv (N = 32)
// ---------------------------------------------------------------------------
// m64nNk8: the warpgroup's 64 rows (warp w: rows 16w + g
// and 16w + g + 8, A in mma.m16n8k8's layout within the warp) times N
// columns of B, read from shared memory through a descriptor. Accumulator
// d[4i + j] of n8 tile i: (row g, column 8i + 2tq + (j & 1)), rows + 8 for
// j >= 2.

// A K-major B tile with no swizzle: 8-row x 16-byte core matrices of 128
// contiguous bytes, the two of a k8 step (k 0-3, 4-7) 128 bytes apart (LBO),
// n8 groups 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keep A's registers alive, unmoved, until the products that read them are
// waited for: the products read them asynchronously.
__device__ __forceinline__ void fence_a(FragA& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a.big[i]), "+r"(a.small[i])::"memory");
}
// Data written to shared memory by ordinary stores or cp.async, made visible
// to the products' (asynchronous) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define VM_TF32_D4(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define VM_TF32_D8(b) VM_TF32_D4(b), VM_TF32_D4(b + 4)

// d += A (64 x 8, registers) · B (8 x N, descriptor).
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
#define VM_TF32_ACC208 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103" \
  "}"
template <>
__device__ __forceinline__ void wgmma_n<208>(float (&d)[104], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 " VM_TF32_ACC208
      ", {%104, %105, %106, %107}, %108, p, 1, 1;\n"
      "}\n"
      : VM_TF32_D8(0), VM_TF32_D8(8), VM_TF32_D8(16), VM_TF32_D8(24),
        VM_TF32_D8(32), VM_TF32_D8(40), VM_TF32_D8(48), VM_TF32_D8(56),
        VM_TF32_D8(64), VM_TF32_D8(72), VM_TF32_D8(80), VM_TF32_D8(88),
        VM_TF32_D8(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef VM_TF32_ACC208
template <>
__device__ __forceinline__ void wgmma_n<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : VM_TF32_D8(0), VM_TF32_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef VM_TF32_D8
#undef VM_TF32_D4

// The three-product step: acc += A_small·B_big + A_big·B_small + A_big·B_big.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const FragA& a, uint64_t b_big,
                                       uint64_t b_small) {
  wgmma_n<N>(d, a.small, b_big);
  wgmma_n<N>(d, a.big, b_small);
  wgmma_n<N>(d, a.big, b_big);
}

}  // namespace
}  // namespace vm_tf32x3
