// conv_wgrad: the weight gradient of a SAME conv of k = 3 taps and dilation
// d over channels-last rows, for the training backward of config #3's
// dilated blocks (ops/conv_train.py :: _blockn_backward, through
// ops/cuda_wgrad.py :: conv_wgrad). For taps j, input channels ci and output
// channels co (x = 0 outside [0, T) within each batch row, h = d (k - 1) / 2):
//   dW[co, ci, j] = sum_{b, t} x[b, t + j d - h, ci] * dz[b, t, co]
// with x (B, T, Cin) and dz (B, T, Cout) bf16, every product exact in f32
// and the sums in f32; dW is written in f32 in the conv weight's layout
// (Cout, Cin, k).
//
// It replaces no Pallas kernel: the JAX package leaves the conv's backward to
// XLA (voicemap_tpu/ops/conv_train.py :: make_fused_blockn_train's bwd,
// linear_transpose of the conv), and on the card cuDNN's NHWC wgrad took
// 50 ms a config #3 train step at B = 2048, 45 of them at block 7 (d = 16,
// wgrad_alg1_engine_NHWC), against 4.8 ms of least time over the four blocks.
//
// What bounds it on the H100: the GEMM is M = Cin, N = Cout, K = B T for
// each tap. At B = 2048 config #3's block 1 (T 3000, 128 -> 128, d 2) moves
// 3.15 GB for 0.60 TFLOP, under the card's ~295 operations a byte, so bytes
// bound it (0.94 ms); blocks 3, 5 and 7 (256, 384, 512 channels) do 1.21,
// 1.36 and 1.21 TFLOP, above that line, so operations bound them.
//
// Design. The output is tiny (3 x 128 x 128 at block 1, 3 x 512 x 512 at
// block 7) and K is long, so the work is split along K:
// - Items. An output tile is 128 input x 128 output channels, all three taps.
//   K is cut into stages of kRows time rows of one batch row (rows past T
//   read TMA's zero fill) and the B * ceil(T / kRows) stages into `splits`
//   contiguous chunks. Item (split s, tile) = s * tiles + tile; a persistent
//   grid of at most one CTA an SM walks them, so the tiles of one chunk run
//   side by side and share its x and dz rows in L2.
// - Roles, as B8's main loop (conv_sm90.cuh): one producer thread keeps a
//   ring of stages full with TMA (cp.async.bulk.tensor) on mbarriers; two
//   consumer warpgroups run wgmma.mma_async m64n128k16 bf16 -> f32, one a
//   half of the tile's 128 input channels, each holding the three taps'
//   accumulators (3 x 64 f32 registers a thread; setmaxnreg gives them 232).
// - Operands. Both are MN-major (wgmma's transposed A and B) with the
//   128-byte swizzle, as TMA writes a box of 64 channels x rows from the 3D
//   maps (C, T, B): a row of 64 channels is one 128-byte line. A stage holds
//   dz's kRows rows x 128 output channels (two boxes) and x's rows t0 - h ...
//   t0 + kRows - 1 + h x 128 input channels (two boxes): tap j's A operand
//   is that slice read from row j d on, a move of the descriptor's start by
//   whole 128-byte lines, so the dz tile and the x slice serve all three
//   taps. Rows outside [0, T) of the batch row come in as TMA's zeros, which
//   is SAME padding with no read across batch rows.
// - The reduction across splits is deterministic: each item writes its
//   three 128 x 128 f32 sums to its own slot of a scratch the wrapper
//   allocates, and a second kernel adds the slots of each tile in split
//   order into dW. No float atomics: two calls give the same bits.
// - Precision: the tensor cores' f32 accumulation truncates, so an item's
//   accumulators are added into its slot every kFlushStages stages and
//   start again from zero (as DeepSeek-V3 promotes its FP8 GEMM's partial
//   sums), which bounds the rows any one accumulator takes.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_sm90.cuh"

namespace {

using sm90conv::fence_acc;
using sm90conv::kAlign;
using sm90conv::kSmemLimit;
using sm90conv::mbar_arrive;
using sm90conv::mbar_expect_tx;
using sm90conv::mbar_init;
using sm90conv::mbar_wait;
using sm90conv::smem_u32;
using sm90conv::tma_load_3d;
using sm90conv::wgmma_commit;
using sm90conv::wgmma_fence;
using sm90conv::wgmma_wait;

constexpr int kTaps = 3;           // the kernel's taps: one accumulator set each
constexpr int kTile = 128;         // input and output channels of a tile
constexpr int kHalf = 64;          // channels of a 128-byte swizzle line (bf16)
constexpr int kLine = 128;         // bytes of a line
constexpr int kRows = 128;         // time rows a stage (K), one x slice for every tap
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 4;
constexpr int kSlot = kTaps * kTile * kTile;  // f32 sums an item writes
// Stages the tensor cores sum into one accumulator before it is added to the
// item's slot. wgmma's f32 accumulation truncates: each k-step shrinks the
// sum by up to ~2^-24 of itself, so the error grows with the k-steps an
// accumulator takes (1.0e-4 of dW's largest element at config #3's block 3
// at B = 2048, 95K rows a split). 128 stages (16384 rows, 1024 k-steps) keep
// it near 2e-5 at any batch for ~5% of the kernel's time (64 stages: 1e-5
// for ~18%); the slot's adds round to nearest.
constexpr int kFlushStages = 128;

struct Problem {
  int d, h;
  int a_rows;       // rows of each x box: kRows + 2h, a multiple of 8
  int a_bytes;      // x's two boxes in a stage
  int stage_bytes;  // x's and dz's boxes, 1024-aligned
  int stages;
  int tpr;          // stages a batch row
  int o_tiles, tiles;
  int splits;
  long long n_stages;  // B * tpr
  long long items;     // splits * tiles
};

// A wgmma descriptor of an MN-major tile with the 128-byte swizzle (layout
// type 1): lines of 128 bytes (64 channels), 8-line groups 1024 bytes apart
// along K (the stride byte offset), 64-channel atoms `lbo` bytes apart along
// M or N (the leading byte offset). The swizzle follows the shared-memory
// address, as TMA wrote it, so the start may move by whole lines.
__device__ __forceinline__ uint64_t desc_mn128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define VM_ACC64_OPERANDS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define VM_ACC8(C, b) \
  C(d[b]), C(d[b + 1]), C(d[b + 2]), C(d[b + 3]), C(d[b + 4]), C(d[b + 5]), C(d[b + 6]), C(d[b + 7])
#define VM_ACC64(C)                                                                        \
  VM_ACC8(C, 0), VM_ACC8(C, 8), VM_ACC8(C, 16), VM_ACC8(C, 24), VM_ACC8(C, 32), VM_ACC8(C, 40), \
      VM_ACC8(C, 48), VM_ACC8(C, 56)

// d (64 x 128, f32) += A (64 x 16) * B (16 x 128), bf16, both MN-major in
// shared memory (transposed A and B).
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VM_ACC64_OPERANDS
      ", %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : VM_ACC64("+f")
      : "l"(da), "l"(db), "r"(1));
}

#undef VM_ACC64
#undef VM_ACC8
#undef VM_ACC64_OPERANDS

__device__ __forceinline__ void split_range(const Problem& p, long long split, long long& lo,
                                            long long& hi) {
  lo = split * p.n_stages / p.splits;
  hi = (split + 1) * p.n_stages / p.splits;
}

// Adds (or, the first time, stores) this thread's accumulators into its
// item's slot and zeroes them. The accumulator gives the thread rows r0 and
// r0 + 8 (input channels) and columns 8 i + 2 q, + 1 (output channels) of
// each 64 x 128 product; no other thread touches those.
__device__ __forceinline__ void flush(float (&acc)[kTaps][64], float* slot, int r0, int q,
                                      bool first) {
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2* at = reinterpret_cast<float2*>(slot + j * kTile * kTile + (r0 + 8 * e) * kTile +
                                               8 * i + 2 * q);
        float2 v = make_float2(acc[j][4 * i + 2 * e], acc[j][4 * i + 2 * e + 1]);
        if (!first) {
          const float2 had = __ldcg(at);
          v.x += had.x;
          v.y += had.y;
        }
        __stcg(at, v);
        acc[j][4 * i + 2 * e] = acc[j][4 * i + 2 * e + 1] = 0.f;
      }
}

// x through mx, dz through mdz; part: items x kSlot f32, item i's sums of
// tap j at [i * kSlot + j * kTile * kTile + ci * kTile + co] (tile-local).
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdz,
                  const Problem p, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const int sb = p.stage_bytes;
  const uint32_t full = base + p.stages * sb;  // p.stages barriers of 8 bytes
  const uint32_t empty = full + 8 * p.stages;
  constexpr uint32_t dz_box = kRows * kLine;  // a dz box; also B's leading byte offset

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    // Producer: one thread keeps the ring full.
    const uint32_t tx = (uint32_t)(p.a_bytes + 2 * dz_box);
    int s = 0;
    uint32_t phase = 0;
    for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int tile = (int)(item % p.tiles);
      const int ci0 = tile / p.o_tiles * kTile, co0 = tile % p.o_tiles * kTile;
      long long lo, hi;
      split_range(p, item / p.tiles, lo, hi);
      for (long long st = lo; st < hi; ++st) {
        const int b = (int)(st / p.tpr), t0 = (int)(st % p.tpr) * kRows;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t bar = full + 8 * s, stg = base + s * sb;
        mbar_expect_tx(bar, tx);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          tma_load_3d(stg + m * p.a_rows * kLine, &mx, bar, ci0 + m * kHalf, t0 - p.h, b);
          tma_load_3d(stg + p.a_bytes + m * dz_box, &mdz, bar, co0 + m * kHalf, t0, b);
        }
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumers: warpgroup wg takes input channels 64 wg ... 64 wg + 63 of the
  // tile, for all three taps.
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;  // this thread's first row (ci)
  // Tap j's A operand: this warpgroup's x box read from row j d on.
  uint32_t a_tap[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) a_tap[j] = (uint32_t)(wg * p.a_rows + j * p.d) * kLine;
  int s = 0;
  uint32_t phase = 0;
  float acc[kTaps][64];
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    long long lo, hi;
    split_range(p, item / p.tiles, lo, hi);
    float* slot = part + item * kSlot;
    bool first = true;
    int prev = -1;
    for (long long st = lo; st < hi; ++st) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t stg = base + s * sb;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) fence_acc(acc[j]);
      wgmma_fence();
      for (int ks = 0; ks < kRows / 16; ++ks) {
        // k-step ks is time rows 16 ks ... 16 ks + 15 of the stage: 2048 bytes on.
        const uint64_t db = desc_mn128(stg + p.a_bytes + ks * 16 * kLine, dz_box);
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          wgmma_tt(acc[j], desc_mn128(stg + a_tap[j] + ks * 16 * kLine, p.a_rows * kLine), db);
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kTaps; ++j) fence_acc(acc[j]);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
      if ((st - lo + 1) % kFlushStages == 0 && st + 1 < hi) {
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kTaps; ++j) fence_acc(acc[j]);
        mbar_arrive(empty + 8 * prev);
        prev = -1;
        flush(acc, slot, r0, q, first);
        first = false;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kTaps; ++j) fence_acc(acc[j]);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);
    flush(acc, slot, r0, q, first);
  }
}

// dW (Cout, Cin, kTaps) f32 from the items' slots, each tile's splits added
// in split order; a thread an element of the tiles' slots, reading them as
// they lie.
__global__ void conv_wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                         int splits, int tiles, int o_tiles, int Cin, int Cout) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n = (long long)tiles * kSlot;
  if (i >= n) return;
  const int tile = (int)(i / kSlot), within = (int)(i % kSlot);
  const int j = within / (kTile * kTile), r = within / kTile % kTile, c = within % kTile;
  const int ci = tile / o_tiles * kTile + r, co = tile % o_tiles * kTile + c;
  if (ci >= Cin || co >= Cout) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += __ldg(part + s * n + i);
  dw[((long long)co * Cin + ci) * kTaps + j] = sum;
}

cudaError_t encode_map(CUtensorMap* map, const void* ptr, int C, int T, int B, int box_rows) {
  const sm90conv::EncodeTiled encode = sm90conv::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kHalf, (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// x (B, T, Cin) and dz (B, T, Cout) bf16, channels last, 16-byte aligned;
// part: splits * tiles * 3 * 128 * 128 f32 of scratch (tiles = ceil(Cin /
// 128) * ceil(Cout / 128)); dw (Cout, Cin, 3) f32. k must be 3, Cin and
// Cout multiples of 8 (TMA's 16-byte row stride), d >= 1 with the slice of
// 128 + 2h rows within TMA's 256-row box (h = d at k = 3, so d <= 64; then
// a stage is at most 96 KiB and two fit in shared memory), splits >= 1. Returns cudaErrorInvalidValue, launching nothing, for
// anything else.
extern "C" int vm_conv_wgrad(const void* x, const void* dz, void* part, void* dw, int B, int T,
                             int Cin, int Cout, int k, int d, int splits, void* stream) {
  if (k != kTaps || Cin <= 0 || Cin % 8 != 0 || Cout <= 0 || Cout % 8 != 0 || d < 1 ||
      splits < 1 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.d = d;
  p.h = d * (k - 1) / 2;
  p.a_rows = (kRows + 2 * p.h + 7) / 8 * 8;
  if (p.a_rows > sm90conv::kMaxBoxRows) return (int)cudaErrorInvalidValue;
  p.a_bytes = 2 * p.a_rows * kLine;
  p.stage_bytes = (p.a_bytes + 2 * kRows * kLine + kAlign - 1) / kAlign * kAlign;
  p.stages = (kSmemLimit - kAlign - 16 * kMaxStages) / p.stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2) return (int)cudaErrorInvalidValue;  // the consumers keep one stage in flight
  p.tpr = (T + kRows - 1) / kRows;
  p.o_tiles = (Cout + kTile - 1) / kTile;
  p.tiles = (Cin + kTile - 1) / kTile * p.o_tiles;
  p.splits = splits;
  p.n_stages = (long long)B * p.tpr;
  p.items = (long long)splits * p.tiles;

  CUtensorMap mx, mdz;
  cudaError_t err = encode_map(&mx, x, Cin, T, B, p.a_rows);
  if (err != cudaSuccess) return (int)err;
  err = encode_map(&mdz, dz, Cout, T, B, kRows);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm90conv::sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const size_t smem = (size_t)kAlign + (size_t)p.stages * p.stage_bytes + 16 * (size_t)p.stages;
  err = cudaFuncSetAttribute(conv_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long grid = p.items < sms ? p.items : sms;
  conv_wgrad_kernel<<<(unsigned)grid, kThreads, smem, s>>>(mx, mdz, p, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)p.tiles * kSlot;
  conv_wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (float*)dw, splits, p.tiles, p.o_tiles, Cin, Cout);
  return (int)cudaGetLastError();
}
