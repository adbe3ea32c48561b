// The Hopper main loop shared by B8 (conv_blockn.cu, bf16 -> f32) and B3 /
// B10 (quant_block.cu, s8 -> s32): the implicit GEMM of a SAME conv of
// dilation d over channels-last rows, M = time, N = Cout, K = k * Cin,
// pooled in pairs (pool 2) or not at all (pool 1), with the caller's
// epilogue.
//
// Roles. A CTA is two consumer warpgroups and one producer warpgroup, one
// CTA an SM (setmaxnreg gives the consumers 232 registers and the producer
// warpgroup 40). Each CTA walks over work items (batch row b, tile of kTileM
// = 128 * MW conv rows, tile of kTileN = 128 output channels) in a
// persistent loop, item = blockIdx.x + i * gridDim.x, the channel tile
// innermost (ops/conv_sm90.py :: schedule mirrors the order). MW is 2 (tiles
// of 256 rows) unless that leaves SMs idle, as at batch 1.
// - Producer (warp 8, one thread): a stage is one 64-byte run of input
//   channels of every tap, the input slice (rows t0 - h ... t0 + kTileM - 1 +
//   h, h = d * (k - 1) / 2 the reach on each side) and the k weight tiles
//   (kTileN channels x the same 64 bytes of tap j);
//   it fills a ring of up to kMaxStages stages with TMA
//   (cp.async.bulk.tensor) on mbarriers.
// - Consumers (warps 0-7): wgmma.mma_async m64n128 on each stage, each
//   warpgroup 64 * MW of the tile's rows; a stage is released once the
//   products that read it are done (wgmma.wait_group 1 after the next stage
//   is issued). At the item's end they pool the sums in pairs (pool 2),
//   finish the epilogue and write the outputs into a tile in shared memory.
// - Writers (warps 9-11): copy that tile to global memory in 16-byte pieces
//   while the consumers multiply the next item.
//
// Layouts in shared memory. Both operands are K-major with the 64-byte
// swizzle, as TMA writes them:
// - The weights are packed on the host as (Cout, k * Kp), each tap's K run
//   padded with zeros to Kp, a multiple of 128 bytes, so a stage never
//   straddles two taps (ops/conv_sm90.py :: pack_taps). A tile is kTileN rows
//   x 64 bytes; channels past Cout are zero-filled by TMA.
// - The input slice is MW boxes of box_rows(MW, 2h) rows x 64 bytes from a
//   3D map (Cin, T, B), contiguous rows: rows t < 0 and t >= T, and channels
//   past Cin, are zero-filled within the batch row, so no read crosses into
//   the neighbouring row. The box height follows the launch's reach: the
//   boxes hold the tile's 128 MW rows and 2h more, in boxes of a multiple of
//   8 rows (each box starts on the swizzle's 512-byte period), so config
//   #1's k = 3 keeps its 136 rows and a reach of 32 (k = 3, d = 16) takes
//   160 at MW = 1 and 144 a box at MW = 2. Tap j of the A operand is the
//   same slice read from row j * d on: its descriptor's start moves by 64 * j
//   * d bytes, whole rows, and no shifted copy is made. The swizzle is a
//   function of the shared-memory address, so the moved start reads what TMA
//   wrote.
// - The epilogue's per-channel rows (bias, mul, add; or alpha, beta, gamma)
//   of each item's channel tile: two buffers, by item parity.
// - The output tile: 128 * MW / pool output rows of kTileN outputs, each row
//   padded by 16 bytes so that the consumers' stores spread over the banks.
//   At pool 1 it is twice pool 2's, which at 4-byte outputs and MW = 2
//   leaves a ring of 2 stages (k = 3) where pool 2 has 3: still two, so a
//   stage is released while the next is multiplied.
// Pooling: the wgmma accumulator gives thread (warp w, lane l) rows 16w + l/4
// and 16w + l/4 + 8 of each 64-row tile; the pool partners 2u and 2u + 1 sit
// in lanes 4 apart, so one __shfl_xor_sync(..., 4) per value pairs them. The
// even lane of a pair takes the pair of its first row, the odd lane the pair
// of its second. At pool 1 each thread writes both of its rows, with no
// shuffle.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90conv {

constexpr int kTileN = 128;     // output channels of a tile
constexpr int kRunBytes = 64;   // K bytes of one tap in a stage: the swizzle's row
constexpr int kPadBytes = 128;  // each tap's K run of the packed weights, padded to this
constexpr int kSteps = kRunBytes / 32;  // wgmma k-steps of 32 bytes in a run
constexpr int kMaxBoxRows = 256;  // TMA's largest box dimension
constexpr int kMaxK = 9;          // the widest kernel the ring holds a stage of
constexpr int kMaxReach = kMaxBoxRows - 128;  // 2h at MW = 1: one box of 128 + 2h rows
constexpr int kBTile = kTileN * kRunBytes;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kWriters = 96;                // its warps 1-3: the epilogue's writers
constexpr int kGroups = kTileN / 8;         // 8-channel groups a writer stores at once
// Registers a thread holds once the roles split (setmaxnreg): each SM quarter
// holds two consumer warps and one producer-warpgroup warp, 2 x 232 + 40 <= 512
// a lane.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 6;
constexpr int kAffRows = 3;    // the epilogue's per-channel rows
constexpr int kAffBytes = 2 * kAffRows * kTileN * 4;
constexpr int kOutPad = 16;  // bytes after each row of the output tile; the pad spreads banks
constexpr int kBarBytes = 32;  // the output tile's two barriers, padded
constexpr int kSmemLimit = 232448;  // the H100's dynamic shared memory per block
constexpr int kAlign = 1024;

// Rows of each of the MW TMA boxes of a tile's input slice: together they
// hold the tile's 128 MW conv rows and the reach 2h, each a multiple of 8.
__host__ __device__ constexpr int box_rows(int mw, int reach) {
  return ((128 * mw + reach + mw - 1) / mw + 7) / 8 * 8;
}

// MW: m64 row tiles per consumer warpgroup (the tile is 128 * MW conv rows);
// OB: bytes an output.
template <int MW, int OB = 4>
struct Tile {
  static constexpr int kTileM = 128 * MW;
  static constexpr int a_bytes(int reach) {  // a multiple of 512
    return MW * box_rows(MW, reach) * kRunBytes;
  }
  // The barriers, the epilogue rows and the output tile: 128 MW / pool rows
  // of kTileN outputs.
  static constexpr int fixed_bytes(int pool) {
    return kAlign + kBarBytes + kAffBytes + kTileM / pool * (kTileN * OB + kOutPad);
  }
  static constexpr int stage_bytes(int k, int reach) {
    return (a_bytes(reach) + k * kBTile + kAlign - 1) / kAlign * kAlign;
  }
  // Stages of the ring that fit beside the fixed part, at most kMaxStages; 0
  // if not even one does, or k or the reach is wider than the kernel takes.
  static int stages(int k, int reach, int pool) {
    if (k > kMaxK || reach > kMaxReach) return 0;
    const int s = (kSmemLimit - fixed_bytes(pool) - 16 * kMaxStages) / stage_bytes(k, reach);
    return s < kMaxStages ? s : kMaxStages;
  }
  static size_t smem_bytes(int k, int reach, int pool, int stages) {
    return (size_t)fixed_bytes(pool) + (size_t)stages * stage_bytes(k, reach) +
           16 * (size_t)stages;
  }
};

// What the kernels need of a launch; filled on the host by make_problem.
struct Problem {
  int T, t_out, Cout, k, h;
  int d;              // dilation: tap j reads rows t + j * d - h
  int pool;           // 1 or 2
  int box_rows;       // rows of each of the MW input boxes
  int a_bytes;        // the input slice of a stage
  int stage_bytes;    // a stage: the slice and k weight tiles, 1024-aligned
  int runs;           // channel runs per tap (Kp / run_elems)
  int run_elems;      // elements in a run
  int kp;             // per-tap padded K of the packed weights, in elements
  int tiles_per_row;  // time tiles per batch row
  int n_tiles;        // channel tiles
  int stages;
  long long items;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma matrix descriptor for a K-major tile with the 64-byte swizzle:
// rows of 64 bytes, 8-row groups 512 bytes apart (layout type 2). The
// swizzle follows the shared-memory address bits, as TMA wrote it, so the
// start may move by whole rows (a tap) or by 32 bytes (a k-step) from a
// 512-byte-aligned tile with no base offset.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// d (64 x 128, f32) += A (64 x 16, bf16) * B (16 x 128, bf16), both from
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VM_ACC64_OPERANDS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VM_ACC64("+f")
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 128, s32) += A (64 x 32, s8) * B (32 x 128, s8), exact.
__device__ __forceinline__ void wgmma_128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VM_ACC64_OPERANDS
      ", %64, %65, p;\n"
      "}\n"
      : VM_ACC64("+r")
      : "l"(da), "l"(db), "r"(1));
}

#undef VM_ACC64
#undef VM_ACC8
#undef VM_ACC64_OPERANDS

// ---------------------------------------------------------------------------
// The kernel body
// ---------------------------------------------------------------------------

template <int MW>
__device__ __forceinline__ void decode(const Problem& p, long long item, long long& b, int& t0,
                                       int& n0) {
  n0 = (int)(item % p.n_tiles) * kTileN;
  const long long r = item / p.n_tiles;
  t0 = (int)(r % p.tiles_per_row) * (128 * MW);
  b = r / p.tiles_per_row;
}

// Two f32 values of the epilogue rows at shared address `addr`. Not
// volatile and touching no memory the compiler tracks, so these loads can be
// scheduled ahead of global stores.
__device__ __forceinline__ float2 rows_at(uint32_t addr) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// The kernel body. Per work item the consumers pool their sums in pairs (pool
// 2) and finish the epilogue: for each pair of channels (col, col + 1) of the
// tile,
//   epi(a, col, lo0, lo1, hi0, hi1) -> V2
// gives the two outputs (lo the sums at conv row 2 pr, hi at 2 pr + 1; a the
// shared address of the tile's epilogue rows, the f32 at a + 4 (r * kTileN +
// c) being aff[r * Cout + n0 + c], zero past Cout). At pool 1 each conv row
// r is its own output row, epi(a, col, s0, s1, s0, s1) with s its sums: the
// pair of a value with itself, which every epilogue here maps to the value's
// own output (max and min of equal values are that value). The outputs go to
// a tile in shared memory, and the writers (warps 1-3 of the producer
// warpgroup) copy it to `out` (B, T / pool, Cout) in 8-output pieces while
// the consumers multiply the next item.
template <int MW, class Acc, class V2, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* mx, const CUtensorMap* mw,
                                    const Problem& p, const float* __restrict__ aff, Epi&& epi,
                                    void* __restrict__ out) {
  constexpr int kElem = sizeof(V2) / 2;
  using Tl = Tile<MW, kElem>;
  constexpr int kRowBytes = kTileN * kElem + kOutPad;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const int sb = p.stage_bytes;
  const uint32_t full = base + p.stages * sb;  // p.stages barriers of 8 bytes
  const uint32_t empty = full + 8 * p.stages;
  const uint32_t pool_full = empty + 8 * p.stages, pool_empty = pool_full + 8;
  const uint32_t aff_s = pool_full + kBarBytes;  // two buffers of kAffRows x kTileN f32
  unsigned char* tile = smem_raw + (aff_s + kAffBytes - raw);  // the output tile
  float* aff_tiles = reinterpret_cast<float*>(smem_raw + (aff_s - raw));

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(pool_full, kConsumers);
    mbar_init(pool_empty, kWriters);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < kConsumers + 32) {
      // Producer: one thread keeps the ring full.
      if (threadIdx.x != kConsumers) return;
      const uint32_t tx = (uint32_t)(p.a_bytes + p.k * kBTile);
      int s = 0;
      uint32_t phase = 0;
      for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
        long long b;
        int t0, n0;
        decode<MW>(p, item, b, t0, n0);
        for (int cb = 0; cb < p.runs; ++cb) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s, st = base + s * sb;
          mbar_expect_tx(bar, tx);
#pragma unroll
          for (int m = 0; m < MW; ++m)
            tma_load_3d(st + m * p.box_rows * kRunBytes, mx, bar, cb * p.run_elems,
                        t0 - p.h + m * p.box_rows, (int)b);
          for (int j = 0; j < p.k; ++j)
            tma_load_2d(st + p.a_bytes + j * kBTile, mw, bar, j * p.kp + cb * p.run_elems, n0);
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    // Writers: thread w copies the 8-output group w % kGroups of output rows
    // w / kGroups, + kWriters / kGroups, ...; a warp covers two whole rows.
    const int w = threadIdx.x - kConsumers - 32, grp = w % kGroups;
    const bool vec = p.Cout % 8 == 0;  // 8-output groups are 8-element aligned
    uint32_t n = 0;
    for (long long item = blockIdx.x; item < p.items; item += gridDim.x, ++n) {
      long long b;
      int t0, n0;
      decode<MW>(p, item, b, t0, n0);
      mbar_wait(pool_full, n & 1);
      const int c0 = n0 + grp * 8;
      const int rows_valid = min(Tl::kTileM / p.pool, p.t_out - t0 / p.pool);
      if (c0 < p.Cout) {
        for (int pr = w / kGroups; pr < rows_valid; pr += kWriters / kGroups) {
          const unsigned char* src = tile + pr * kRowBytes + grp * 8 * kElem;
          unsigned char* dst = static_cast<unsigned char*>(out) +
                               ((b * p.t_out + t0 / p.pool + pr) * (long long)p.Cout + c0) *
                                   kElem;
          if (vec && c0 + 8 <= p.Cout) {
#pragma unroll
            for (int h = 0; h < kElem / 2; ++h)
              __stcs(reinterpret_cast<uint4*>(dst) + h, reinterpret_cast<const uint4*>(src)[h]);
            if (kElem == 1)
              __stcs(reinterpret_cast<uint2*>(dst), *reinterpret_cast<const uint2*>(src));
          } else {
            for (int e = 0; e < 8 && c0 + e < p.Cout; ++e)
#pragma unroll
              for (int byte = 0; byte < kElem; ++byte) dst[e * kElem + byte] = src[e * kElem + byte];
          }
        }
      }
      mbar_arrive(pool_empty);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumers: warpgroup wg multiplies conv rows 64 MW wg ... 64 MW (wg + 1) - 1.
  const uint32_t a_wg = (uint32_t)(threadIdx.x >> 7) * 64 * MW * kRunBytes;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool even = (g & 1) == 0;
  // This thread's first conv row in its first 64-row tile (its second is 8
  // on), and at pool 2 the pooled row of its pairs.
  const int r0 = (threadIdx.x >> 7) * 64 * MW + ((threadIdx.x >> 5) & 3) * 16 + g;
  const int pr0 = (even ? r0 : r0 + 7) >> 1;
  int s = 0;
  uint32_t phase = 0, n = 0;
  Acc acc[MW][64];
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x, ++n) {
    long long b;
    int t0, n0;
    decode<MW>(p, item, b, t0, n0);
    // This tile's epilogue rows, loaded now and stored after the products so
    // that the load's latency hides under them.
    constexpr int kAffPer = (kAffRows * kTileN + kConsumers - 1) / kConsumers;
    float rows_v[kAffPer];
#pragma unroll
    for (int v = 0; v < kAffPer; ++v) {
      const int i = threadIdx.x + v * kConsumers, r = i / kTileN, c = n0 + i % kTileN;
      rows_v[v] = i < kAffRows * kTileN && c < p.Cout ? __ldg(aff + (long long)r * p.Cout + c) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0;
    int prev = -1;
    for (int cb = 0; cb < p.runs; ++cb) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t st = base + s * sb;
#pragma unroll
      for (int m = 0; m < MW; ++m) fence_acc(acc[m]);
      wgmma_fence();
      for (int j = 0; j < p.k; ++j) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          // Tap j reads the slice from row j * d on; k-step ks is bytes 32 ks of the run.
          const uint64_t db = desc_sw64(st + p.a_bytes + j * kBTile + ks * 32);
#pragma unroll
          for (int m = 0; m < MW; ++m)
            wgmma_128(acc[m], desc_sw64(st + a_wg + (m * 64 + j * p.d) * kRunBytes + ks * 32),
                      db);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int m = 0; m < MW; ++m) fence_acc(acc[m]);
      if (p.stages > 1) {
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) mbar_arrive(empty + 8 * prev);
        prev = s;
      } else {
        wgmma_wait<0>();  // one stage: release it before the next can load
        mbar_arrive(empty + 8 * s);
      }
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MW; ++m) fence_acc(acc[m]);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);

    // This item's rows take the buffer of item n - 2, whose readers all
    // passed the barrier of item n - 1 before this thread did.
    float* a = aff_tiles + (n & 1) * kAffRows * kTileN;
#pragma unroll
    for (int v = 0; v < kAffPer; ++v) {
      const int i = threadIdx.x + v * kConsumers;
      if (i < kAffRows * kTileN) a[i] = rows_v[v];
    }
    // The rows are written. The barrier hands out a zero that the row
    // addresses add, so no read of them moves above it.
    uint32_t zero;
    asm volatile("bar.sync 1, %1;\nmov.u32 %0, 0;\n" : "=r"(zero) : "n"(kConsumers) : "memory");
    const uint32_t a_s = aff_s + (n & 1) * kAffRows * kTileN * 4 + zero;
    mbar_wait(pool_empty, (n & 1) ^ 1);  // the writers are done with the last tile
    if (p.pool == 2) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * q;
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          Acc lo[2], hi[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const Acc mine = even ? acc[m][4 * i + 2 + e] : acc[m][4 * i + e];
            const Acc got = __shfl_xor_sync(0xffffffffu, mine, 4);
            lo[e] = even ? acc[m][4 * i + e] : got;
            hi[e] = even ? got : acc[m][4 * i + 2 + e];
          }
          *reinterpret_cast<V2*>(tile + (pr0 + 32 * m) * kRowBytes + col * kElem) =
              epi(a_s, col, lo[0], lo[1], hi[0], hi[1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * q;
#pragma unroll
        for (int m = 0; m < MW; ++m) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // rows r0 and r0 + 8 of the m-th 64-row tile
            const Acc s0 = acc[m][4 * i + 2 * e], s1 = acc[m][4 * i + 2 * e + 1];
            *reinterpret_cast<V2*>(tile + (r0 + 8 * e + 64 * m) * kRowBytes + col * kElem) =
                epi(a_s, col, s0, s1, s0, s1);
          }
        }
      }
    }
    mbar_arrive(pool_full);  // releases this thread's writes to the writers
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The launch's problem and its two tensor maps: x (B, T, Cin) channels last
// and the packed weights (Cout, k * kp), elements of `elem` bytes; k odd,
// dilation d, pool 1 or 2.
template <int MW, int OB>
cudaError_t make_problem(Problem* p, CUtensorMap* mx, CUtensorMap* mw, const void* x,
                         const void* w, int B, int T, int Cin, int Cout, int k, int d, int pool,
                         int elem) {
  if (pool != 1 && pool != 2) return cudaErrorInvalidValue;
  const int run_elems = kRunBytes / elem, pad = kPadBytes / elem;
  const int kp = (Cin + pad - 1) / pad * pad;
  const int reach = d * (k - 1);
  p->T = T;
  p->t_out = T / pool;
  p->Cout = Cout;
  p->k = k;
  p->h = reach / 2;
  p->d = d;
  p->pool = pool;
  p->box_rows = box_rows(MW, reach);
  p->a_bytes = Tile<MW, OB>::a_bytes(reach);
  p->stage_bytes = Tile<MW, OB>::stage_bytes(k, reach);
  p->runs = kp / run_elems;
  p->run_elems = run_elems;
  p->kp = kp;
  p->tiles_per_row = (p->t_out * pool + Tile<MW>::kTileM - 1) / Tile<MW>::kTileM;
  p->n_tiles = (Cout + kTileN - 1) / kTileN;
  p->stages = Tile<MW, OB>::stages(k, reach, pool);
  p->items = (long long)B * p->tiles_per_row * p->n_tiles;
  if (p->stages < 1) return cudaErrorInvalidValue;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType dt =
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint32_t ones[3] = {1, 1, 1};
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)Cin * elem, (cuuint64_t)T * Cin * elem};
    const cuuint32_t box[3] = {(cuuint32_t)run_elems, (cuuint32_t)p->box_rows, 1};
    if (encode(mx, dt, 3, const_cast<void*>(x), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)k * kp, (cuuint64_t)Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)k * kp * elem};
    const cuuint32_t box[2] = {(cuuint32_t)run_elems, (cuuint32_t)kTileN};
    if (encode(mw, dt, 2, const_cast<void*>(w), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// Tiles of 256 rows unless they would leave SMs idle, as at small B, or
// their ring would hold fewer than 2 stages: then tiles of 128, twice as
// many.
template <int OB>
bool wide_tiles(int B, int T, int Cout, int k, int d, int pool, int sms) {
  const long long items =
      (long long)B * ((T / pool * pool + 255) / 256) * ((Cout + kTileN - 1) / kTileN);
  return items >= sms && Tile<2, OB>::stages(k, d * (k - 1), pool) >= 2;
}

// Launch `kernel` over p's items on at most one CTA per SM.
template <int MW, int OB, class... KArgs, class... Args>
cudaError_t launch(void (*kernel)(CUtensorMap, CUtensorMap, Problem, KArgs...),
                   const CUtensorMap& mx, const CUtensorMap& mw, const Problem& p, int sms,
                   cudaStream_t stream, Args... args) {
  const size_t smem = Tile<MW, OB>::smem_bytes(p.k, 2 * p.h, p.pool, p.stages);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = p.items < sms ? p.items : sms;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(mx, mw, p, args...);
  return cudaGetLastError();
}

}  // namespace sm90conv
