// B3: the int8 mid block of the encoder's serving path (blocks 1+): SAME conv
// (k=3, dilation d) in s8 x s8 -> s32, max-pool 2 (or none: pool 1), and the
// folded epilogue, in one pass.
//
// Replaces voicemap_tpu/ops/pallas_quant_block.py :: _kernel, _kernel_xk3 and
// _kernel_xk (wrapper pallas_quant_block); the three TPU variants are three
// ways of laying the same GEMM out on the MXU, and one Hopper kernel covers
// them. The TPU kernels take dilation 1 and pool 2 only; the JAX package
// serves its dilated and pool-1 blocks (config #3's) through XLA's int8 conv
// (voicemap_tpu/models/quant_infer.py :: _quant_block, rhs_dilation), which
// this kernel computes too. For row b, time t and output channel co:
//   acc[t] = sum_{j, ci} x[t + (j - 1) * d, ci] * w[j, ci, co]   (x = 0 outside [0, T))
//   sel[u] = alpha[co] > 0 ? max(acc[2u], acc[2u + 1]) : min(acc[2u], acc[2u + 1])
//            at pool 2; acc[u] at pool 1
//   z[u]   = relu(float(sel[u]) + beta[co]) * alpha[co] + gamma[co]
//   out[u] = clamp(round_half_even(z[u]), -127, 127) as int8, or z[u] rounded
//            to bf16 (or kept in f32) for the last block.
// Pooling the raw accumulator before the epilogue, by the sign of alpha, is
// what the TPU kernel does, and equals models/quant_infer.py :: _quant_block
// (epilogue, requantize, then pool) bit for bit: the epilogue and its
// roundings are monotone in acc, nondecreasing for alpha > 0 and
// nonincreasing for alpha < 0. The int32 sums are exact in any order; the
// epilogue is rounded op by op (__fadd_rn, __fmul_rn), so nvcc cannot
// contract it into an FMA, and the output equals the plain version exactly.
// An odd T at pool 2 drops the last step from the pool; the conv still reads
// it.
//
// What bounds it on the H100: operations. At config #1 and B=2048, block 1
// (128 -> 256, T 3000) is 1.21 TOP against 1.57 GB, block 2 (256 -> 384,
// T 1500) 1.81 TOP against 1.38 GB, block 3 (384 -> 512, T 750, bf16 out)
// 1.81 TOP against 1.38 GB: 0.61, 0.92 and 0.92 ms at the 1,979 TOP/s int8
// tensor-core peak, above the bytes' 0.47, 0.41 and 0.41 ms at 3.35 TB/s.
//
// Design (conv_sm90.cuh, shared with B8): the implicit GEMM M = time, N =
// Cout, K = 3 * Cin on wgmma.mma_async.m64n128k32 s8 -> s32, both operands
// loaded by TMA into a ring of stages, a producer warp, two consumer
// warpgroups and three writer warps, a persistent grid of one CTA an SM,
// tiles of 256 conv rows x 128 channels. Against the first design
// (warp-level m16n8k32 products with 32-bit shared loads, a CTA per
// 64-channel column that kept its weights resident and re-read the input
// once per column):
// - fragment traffic: wgmma reads both operands from shared memory itself,
//   a 64 x 128 product per instruction;
// - input re-reads: a tile is 128 channels wide, so the input passes L2 ->
//   SM Cout / 128 times (2, 3, 4 at blocks 1-3), not Cout / 64, and each
//   input byte serves the three taps (a 64-byte move of the A descriptor);
// - the weights stream in 64-byte runs beside the input slice, so shared
//   memory no longer bounds Cin (the old cap of 480 went with the resident
//   slab; MAX_CIN in the wrapper keeps the int32 sum from overflowing);
// - synchronisation: mbarriers between the producer and the consumers, no
//   __syncthreads in the loop, and the writers store one tile while the
//   consumers multiply the next.
// The weights come packed (Cout, 3 * Kp), each tap's Cin padded with zeros
// to Kp, a multiple of 128 (ops/conv_sm90.py :: pack_taps).
//
// B10, the stage prefixes that attribute this kernel's time, are the same
// kernel cut short by its STAGE template parameter. They replace
// benchmarks/bench_qblock_attrib.py :: _kernel_staged and _kernel_xk, whose
// stages 1-2 (a (t+2, Cin) @ (Cin, 3 * Cout) product, then the shifted tap
// adds) have no separate form here: the taps are already inside K = 3 * Cin,
// the layout of _kernel_xk. Unlike the TPU prefixes, each writes a defined
// output, so it can be held against a plain version:
// (B10 runs at dilation 1 and pool 2, the prefixes' own shapes.)
//   kStageMma:  the tile loads and the products over K; writes acc[2u] as int32;
//   kStagePool: + the pair select by the sign of alpha; writes sel[u] int32;
//   kStageFull: + the epilogue and requantization: B3 itself, which every
//               B3 launch runs.
//
// The train epilogue (kTrain; the int8 training forward, voicemap_tpu/ops/
// conv_train.py make_fused_blockn_train(quant="int8"), whose conv the JAX
// package leaves to XLA's int8 conv) is the same main loop at pool 1 with
// another epilogue: per output channel co, with s[co] = sx * sw[co] formed
// in f32 by the wrapper,
//   a[t] = max(float(acc[t]) * s[co] + b[co], 0)   rounded op by op
// written channels last in bf16 or f32, the dequantized activation that the
// train op's pool pass (B7) reads. No requantization and no pool: B7 pools,
// and the BatchNorm statistics read every a. Bit for bit against its plain
// version, since the int32 sums are exact and the epilogue's roundings fixed.
// Bytes bound it at blocks 1-2 of config #1 (3.15 GB of bf16 a written at
// block 1, B=2048), operations at block 3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_sm90.cuh"

namespace {

constexpr int kTaps = 3;

enum OutKind { kInt8 = 0, kBF16 = 1, kF32 = 2 };
// B10's prefixes, then B3's full epilogue; kTrain is no prefix: the train
// forward's dequantizing epilogue at pool 1.
enum Stage { kStageMma = 0, kStagePool = 1, kStageFull = 2, kTrain = 3 };
template <int OUT, int STAGE>
constexpr int kOutBytes = STAGE == kStageMma || STAGE == kStagePool
                              ? 4
                              : OUT == kInt8 ? 1 : OUT == kBF16 ? 2 : 4;

// x: (B, T, Cin) int8 through mx; w: (Cout, 3 * Kp) int8 through mw; aff:
// (3, Cout) f32 rows alpha, beta, gamma (kTrain: s, b and a row not read);
// out: (B, T / pool, Cout), int32 for the mma and pool stages.
template <int MW, int OUT, int STAGE>
__global__ void __launch_bounds__(sm90conv::kThreads, 1)
quant_block_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const sm90conv::Problem p, const float* __restrict__ aff,
                   void* __restrict__ out) {
  using V2 = std::conditional_t<
      STAGE == kStageMma || STAGE == kStagePool, int2,
      std::conditional_t<OUT == kInt8, char2,
                         std::conditional_t<OUT == kBF16, __nv_bfloat162, float2>>>;
  sm90conv::run<MW, int, V2>(
      &mx, &mw, p, aff,
      [&](uint32_t a, int col, int lo0, int lo1, int hi0, int hi1) {
        constexpr int N = sm90conv::kTileN;
        if constexpr (STAGE == kStageMma) {
          return make_int2(lo0, lo1);
        } else if constexpr (STAGE == kTrain) {
          // pool 1: lo and hi are the same conv row's sums
          const float2 sc = sm90conv::rows_at(a + 4 * col);
          const float2 bi = sm90conv::rows_at(a + 4 * (N + col));
          const float a0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(lo0), sc.x), bi.x), 0.f);
          const float a1 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(lo1), sc.y), bi.y), 0.f);
          if constexpr (OUT == kBF16) {
            return __floats2bfloat162_rn(a0, a1);
          } else {
            return make_float2(a0, a1);
          }
        } else {
          const float2 al = sm90conv::rows_at(a + 4 * col);
          const int s0 = al.x > 0.f ? max(lo0, hi0) : min(lo0, hi0);
          const int s1 = al.y > 0.f ? max(lo1, hi1) : min(lo1, hi1);
          if constexpr (STAGE == kStagePool) {
            return make_int2(s0, s1);
          } else {
            const float2 be = sm90conv::rows_at(a + 4 * (N + col));
            const float2 ga = sm90conv::rows_at(a + 4 * (2 * N + col));
            const float h0 = fmaxf(__fadd_rn(__int2float_rn(s0), be.x), 0.f);
            const float h1 = fmaxf(__fadd_rn(__int2float_rn(s1), be.y), 0.f);
            const float z0 = __fadd_rn(__fmul_rn(h0, al.x), ga.x);
            const float z1 = __fadd_rn(__fmul_rn(h1, al.y), ga.y);
            if constexpr (OUT == kInt8) {
              // half to even, as jnp.round, then clamped to the symmetric int8 grid
              return make_char2((signed char)min(max(__float2int_rn(z0), -127), 127),
                                (signed char)min(max(__float2int_rn(z1), -127), 127));
            } else if constexpr (OUT == kBF16) {
              return __floats2bfloat162_rn(z0, z1);
            } else {
              return make_float2(z0, z1);
            }
          }
        }
      },
      out);
}

template <int MW, int OUT, int STAGE>
cudaError_t launch_tiles(const void* x, const void* w, const void* aff, void* out, int B, int T,
                         int Cin, int Cout, int d, int pool, int sms, cudaStream_t s) {
  constexpr int ob = kOutBytes<OUT, STAGE>;
  sm90conv::Problem p;
  CUtensorMap mx, mw;
  cudaError_t err =
      sm90conv::make_problem<MW, ob>(&p, &mx, &mw, x, w, B, T, Cin, Cout, kTaps, d, pool, 1);
  if (err != cudaSuccess) return err;
  return sm90conv::launch<MW, ob>(quant_block_kernel<MW, OUT, STAGE>, mx, mw, p, sms, s,
                                  (const float*)aff, out);
}

template <int OUT, int STAGE>
cudaError_t launch(const void* x, const void* w, const void* aff, void* out, int B, int T,
                   int Cin, int Cout, int d, int pool, cudaStream_t s) {
  const int sms = sm90conv::sm_count();
  if (sms == 0) return cudaErrorNoDevice;
  if (sm90conv::wide_tiles<kOutBytes<OUT, STAGE>>(B, T, Cout, kTaps, d, pool, sms))
    return launch_tiles<2, OUT, STAGE>(x, w, aff, out, B, T, Cin, Cout, d, pool, sms, s);
  return launch_tiles<1, OUT, STAGE>(x, w, aff, out, B, T, Cin, Cout, d, pool, sms, s);
}

}  // namespace

// out_kind: 0 int8 (requantized), 1 bf16, 2 f32 (dequantized, last block).
// w is (Cout, 3 * Kp) int8, tap j's K run at [j * Kp, j * Kp + Cin) and
// zeros up to Kp = Cin rounded up to 128. Cin must be a multiple of 32, the
// reach 2d at most kMaxReach = 128, pool 1 or 2; x and w 16-byte aligned.
// Returns cudaErrorInvalidValue, launching nothing, for anything else.
extern "C" int vm_quant_block(const void* x, const void* w, const void* aff,
                              void* out, int B, int T, int Cin, int Cout, int d, int pool,
                              int out_kind, void* stream) {
  if (Cin <= 0 || Cin % 32 != 0 || out_kind < 0 || out_kind > 2 || d < 1 ||
      2 * d > sm90conv::kMaxReach || (pool != 1 && pool != 2))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < pool || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kInt8)
    return (int)launch<kInt8, kStageFull>(x, w, aff, out, B, T, Cin, Cout, d, pool, s);
  if (out_kind == kBF16)
    return (int)launch<kBF16, kStageFull>(x, w, aff, out, B, T, Cin, Cout, d, pool, s);
  return (int)launch<kF32, kStageFull>(x, w, aff, out, B, T, Cin, Cout, d, pool, s);
}

// The train epilogue: out (B, T, Cout) = max(float(acc) * s + b, 0) in bf16
// (out_kind 1) or f32 (2), pool 1; aff (3, Cout) f32 rows s, b and one not
// read. The same limits as vm_quant_block.
extern "C" int vm_quant_block_train(const void* x, const void* w, const void* aff, void* out,
                                    int B, int T, int Cin, int Cout, int d, int out_kind,
                                    void* stream) {
  if (Cin <= 0 || Cin % 32 != 0 || (out_kind != kBF16 && out_kind != kF32) || d < 1 ||
      2 * d > sm90conv::kMaxReach)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < 1 || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kBF16)
    return (int)launch<kBF16, kTrain>(x, w, aff, out, B, T, Cin, Cout, d, 1, s);
  return (int)launch<kF32, kTrain>(x, w, aff, out, B, T, Cin, Cout, d, 1, s);
}

// B10. stage: 0 mma (out int32, acc[2u]), 1 pool (out int32, sel[u]), 2 full
// (out int8, the mid block's requantized output). The same limits as above.
extern "C" int vm_quant_block_stage(const void* x, const void* w, const void* aff,
                                    void* out, int B, int T, int Cin, int Cout,
                                    int stage, void* stream) {
  if (Cin <= 0 || Cin % 32 != 0 || stage < 0 || stage > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < 2 || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == kStageMma)
    return (int)launch<kInt8, kStageMma>(x, w, aff, out, B, T, Cin, Cout, 1, 2, s);
  if (stage == kStagePool)
    return (int)launch<kInt8, kStagePool>(x, w, aff, out, B, T, Cin, Cout, 1, 2, s);
  return (int)launch<kInt8, kStageFull>(x, w, aff, out, B, T, Cin, Cout, 1, 2, s);
}
