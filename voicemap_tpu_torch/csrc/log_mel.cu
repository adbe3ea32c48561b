// B6: fused framing + window + spectrum + power + mel + log, one pass over
// the waveform, by two kernels chosen by n_fft.
//
// Replaces voicemap_tpu/ops/pallas_melspec.py :: _fused_kernel and
// _preframed_kernel (core _dft_mel; wrapper pallas_log_mel). It computes the
// wrapper's function, not its blocks:
//   out[b, f, m] = log(sum_k |X_f[k]|^2 · fb[k, m] + eps)
// where X_f is the spectrum of frame f = x[b, f·hop .. f·hop + win) under the
// periodic Hann window, zero-padded to n_fft, k = 0 .. n_fft/2, and fb the
// Slaney mel filterbank (K = n_fft/2 + 1, M). f32 in, f32 out.
//
// What bounds the function on the H100: bytes. At config #4 (B=2048,
// T=48000, hop 128, win 384, n_fft 512, M 64; 373 frames) it reads 393 MB
// and writes 196 MB, 0.18 ms at the H100 SXM's published 3.35 TB/s; by a
// real FFT it needs 10.5 GFLOP (window, 512-point real FFT, power, mel
// bands, log), 0.16 ms at the f32 CUDA-core rate of 67 TFLOP/s (700 W).
//
// The TPU kernel computes the DFT as a matmul against cos/sin bases, 302
// GFLOP at config #4: right for a machine with a matrix unit and no FFT,
// 29x the work here. So where n_fft is a power of two this card's CUDA
// cores run an FFT. For any other n_fft the DFT stays a matmul, and it runs
// on the tensor cores in 3xTF32 (tf32x3.cuh): TF32 alone keeps about three
// digits, as much error on the power as the 1e-3 the log-mel is held to;
// the split into big and small tf32 parts and three products keeps almost
// all of f32.
//
// log_mel_fft_kernel, for n_fft a power of two in [64, 1024] (config #4):
// - one CTA owns one row and a tile of 64 frames; it reads the waveform
//   span of its frames into shared memory once (33 KB at hop 128, win 384:
//   each sample belongs to win/hop = 3 frames), with the tables;
// - each of its 8 warps takes 8 frames in turn; a frame's real FFT of N
//   points is a complex FFT of nc = N/2 points, z[n] = x[2n] + i·x[2n+1]
//   (windowed on the load, zero past win), by Stockham passes of radix 8,
//   8, 4 at nc = 256 (mel_fft.plan): each lane holds the R points of its
//   butterflies in registers, twiddles them from its pass's table (a
//   lane's R - 1 twiddles adjacent, so the lanes' reads miss each other's
//   banks), transforms them, and writes them to the warp's buffer, one
//   pad slot after every 8 complex values so that the strided reads and
//   writes of the exchanges fall on distinct banks;
// - the split pass X[k] = ½(Z[k] + Z*[nc−k]) − ½·i·W_N^k·(Z[k] − Z*[nc−k])
//   gives bins 0 .. nc (both ends real), then the power re² + im² lands over
//   the spent buffer, each filter's band of nonzero bins is summed in bin
//   order against its packed weights, and the log is stored, each frame's
//   M floats contiguous. Neither frames nor spectra reach device memory.
// The FFT's rounding error grows as O(log N) ulps of the frame's energy,
// the DFT's as O(win): far inside the 1e-3 on the log-mel. The twiddles come
// from float64 rounded once (the wrapper's tables). Sum orders: the
// butterflies' as written, the bands in bin order; no bit-exactness with the
// plain version (a DFT matmul) is claimed.
//
// log_mel_tc_kernel, the DFT route, for any other n_fft <= 574 (the librosa
// n_fft 400, for one): frames (F x win) times bases (win x 2K) on the
// tensor cores in 3xTF32, as wgmma m64n208k8 (host side ops/mel_dft_tc.py).
// One CTA, one warpgroup, owns one row and a tile of 64 frames, the m64
// rows (warp w: frames 16w + g and 16w + g + 8):
// - it stages the waveform span of its frames in shared memory once, read
//   once from device memory, as rows of hop samples at a pitch of hop
//   rounded up to 4 mod 8, frame f starting at row f: the frames are never
//   materialised, and any hop, any win <= n_fft and any T >= win are taken.
//   A, the frames, goes from registers: each k8 step's fragment is read
//   straight out of the span (a table of column offsets maps sample n of a
//   frame to its row and column) and split into big and small on the load;
//   the pitch puts a fragment's eight frames on eight different banks;
// - B, the windowed bases, split on the host once, bin k's cos and sin in
//   adjacent columns (K padded to the n8 tile: 402 -> 408 columns at n_fft
//   400), packed as K-major core matrices a k8 step and 208 columns at a
//   time, streams through a ring of three slabs in shared memory, one bulk
//   copy a slab issued by one thread and awaited on the slab's mbarrier;
//   L2 holds the bases for every CTA;
// - each slab's three products are one wgmma group, issued while the
//   previous slab's still run; waiting for that one frees its A registers
//   and its slab, which is refilled two slabs ahead. No block barrier
//   inside a pass;
// - the columns go in passes of 208 (26 n8 tiles, 104 bins), a thread's 104
//   accumulators; an n8 tile's accumulator pair (2tq, 2tq + 1) is re and im
//   of one bin, so the power re^2 + im^2 forms in registers;
// - after each pass the power tile lands in shared memory over the spent
//   slabs, and each filter whose band reaches the pass's bins adds them, in
//   bin order, to its per-(frame, filter) sum in shared memory (a lane's
//   filter for four frames at once); after the last pass the log is taken
//   and stored, each frame's M floats contiguous.
// At n_fft 400, hop 160 a CTA takes ~104 KB of shared memory: two CTAs an
// SM. Its work is 3 x 2·win·2K tensor-core products a frame, and the bases
// (1.3 MB at n_fft 400) cross L2 once a CTA. Sum orders: the tensor cores'
// within a k8 step, the steps in order, each band in bin order. No
// bit-exactness with the plain version (an f32 DFT matmul) is claimed; the
// split's error, ~2^-21 of each product, is far inside the 1e-3 on the
// log-mel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;  // the FFT route's CTA
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One bulk copy of `bytes` (a multiple of 16) from global to shared memory
// by the copy engine, completing a transaction on `bar`, which expects them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The DFT route: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;                      // one warpgroup
constexpr int kTcFrames = 64;                        // its m64 rows (mel_dft_tc.FRAME_TILE)
constexpr int kTcN = 208;                            // columns a pass: wgmma's n
constexpr int kTcAcc = kTcN / 2;                     // accumulators a thread
constexpr int kTcPassTiles = kTcN / 8;               // n8 tiles a pass, 4 bins each
constexpr int kTcPassBins = 4 * kTcPassTiles;
// A pass's power rows, 4 mod 8 apart: rows g = 0..7 on 8 bank groups.
constexpr int kTcPowerPitch = kTcPassBins + (4 - kTcPassBins % 8 + 8) % 8;
constexpr int kTcKSteps = 1;                         // k8 steps a slab
constexpr int kTcStages = 3;                         // slabs: one multiplied, two loading
constexpr int kTcTileFloats = kTcPassTiles * 64;     // a plane's k8 step: n8 tiles x 2 core
                                                     // matrices
constexpr int kTcSlabFloats = kTcKSteps * 2 * kTcTileFloats;  // big and small planes
constexpr int kMaxBins = 288;                        // n_fft <= 574
constexpr int kMaxPasses = (2 * kMaxBins / 8 + kTcPassTiles - 1) / kTcPassTiles;
static_assert(kTcFrames * kTcPowerPitch <= kTcStages * kTcSlabFloats,
              "a pass's power tile must fit over the slabs");

// Load `it`, the CTA's it-th slab over all passes (pass it / n_slabs, slab
// it % n_slabs: its kTcKSteps k8 steps of both planes, contiguous in frag,
// ops/mel_dft_tc.fragments), into stage it % kTcStages: one thread, one bulk
// copy.
__device__ __forceinline__ void load_tc_slab(int it, int n_slabs, int n_passes, float* slabs,
                                             const float* __restrict__ frag, uint64_t* full) {
  if (it >= n_slabs * n_passes) return;
  const int stage = it % kTcStages;
  bulk_load(slabs + stage * kTcSlabFloats, frag + (long long)it * kTcSlabFloats,
            kTcSlabFloats * 4, full + stage);
}

// One slab's products, issued while the previous slab's are still running:
// wait for slab `it` (the CTA's it-th), load and split A (frames x its k8
// steps) into `a`, issue the three products of each k8 step as one group,
// then wait until only that group runs, so the previous group's A
// (`a_prev`) and slab are free, and thread 0 refills that slab's stage with
// slab it + kTcStages - 1 of this pass.
__device__ __forceinline__ void tc_slab(int it, int st, int n_slabs, int n_passes,
                                        float* slabs, const float* __restrict__ frag,
                                        uint64_t* full, const float* xs, const int* off,
                                        int r0, int r1, int tq,
                                        vm_tf32x3::FragA (&a)[kTcKSteps],
                                        vm_tf32x3::FragA (&a_prev)[kTcKSteps],
                                        float (&acc)[kTcAcc]) {
#pragma unroll
  for (int j = 0; j < kTcKSteps; ++j) {
    const int n0 = 8 * (st * kTcKSteps + j);
    vm_tf32x3::load_a(a[j], xs, r0, r1, off[n0 + tq], off[n0 + tq + 4]);
  }
  mbar_wait(full + it % kTcStages, (it / kTcStages) & 1);  // slab it is in
  const float* slab = slabs + (it % kTcStages) * kTcSlabFloats;
  vm_tf32x3::fence_acc(acc);
  vm_tf32x3::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTcKSteps; ++j) {
    const float* big = slab + j * 2 * kTcTileFloats;
    vm_tf32x3::wgmma3<kTcN>(acc, a[j], vm_tf32x3::desc_kmajor(big),
                            vm_tf32x3::desc_kmajor(big + kTcTileFloats));
  }
  vm_tf32x3::wgmma_commit();
  vm_tf32x3::wgmma_wait<1>();  // slab it - 1's products are done, for the warpgroup
  vm_tf32x3::fence_acc(acc);
#pragma unroll
  for (int j = 0; j < kTcKSteps; ++j) vm_tf32x3::fence_a(a_prev[j]);
  if (threadIdx.x == 0 && st + kTcStages - 1 < n_slabs)
    load_tc_slab(it + kTcStages - 1, n_slabs, n_passes, slabs, frag, full);
}

__global__ void __launch_bounds__(kTcThreads)
log_mel_tc_kernel(const float* __restrict__ x, const float* __restrict__ frag,
                  const int32_t* __restrict__ offs, const float* __restrict__ weights,
                  const int32_t* __restrict__ bands, float* __restrict__ out, int T,
                  int n_frames, int n_tiles, int hop, int pitch, int n_rows, int ksteps,
                  int n_passes, int M, int n_weights, float log_eps) {
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // a barrier a stage: its slab is in
  float* slabs = smem + 32;                             // the basis slabs, later a pass's power
  float* mel = slabs + kTcStages * kTcSlabFloats;       // (frames, M) band sums
  float* wts = mel + kTcFrames * M;                     // the filters' nonzero runs
  int* bnd = reinterpret_cast<int*>(wts + n_weights);   // (3, M): first, end, run offset;
                                                        // (2, passes): filters a pass reaches
  int* off = bnd + 3 * M + 2 * n_passes;                // column offsets in the span
  float* xs = reinterpret_cast<float*>(off + 8 * ksteps);  // n_rows rows of hop samples

  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * kTcFrames;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // The span read once, row by row; samples past the row (frames past
  // n_frames) are 0.
  const float* row = x + (long long)b * T;
  const long long start = (long long)f0 * hop;
  for (int r = warp; r < n_rows; r += kTcThreads / 32)
    for (int c = lane; c < hop; c += 32) {
      const long long p = start + (long long)r * hop + c;
      xs[r * pitch + c] = p < T ? row[p] : 0.f;
    }
  for (int i = threadIdx.x; i < 8 * ksteps; i += kTcThreads) off[i] = offs[i];
  for (int i = threadIdx.x; i < n_weights; i += kTcThreads) wts[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M + 2 * n_passes; i += kTcThreads) bnd[i] = bands[i];
  for (int i = threadIdx.x; i < kTcFrames * M; i += kTcThreads) mel[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The span offsets of this thread's A rows, frames 16w + g and + 8.
  const int r0 = (16 * warp + g) * pitch, r1 = r0 + 8 * pitch;
  const int n_slabs = ksteps / kTcKSteps;
  for (int pass = 0; pass < n_passes; ++pass) {
    const int it0 = pass * n_slabs;  // the pass's first slab, counted over the passes
    if (threadIdx.x == 0) {
      vm_tf32x3::fence_proxy_async();  // the last pass's power reads, before the copies
      for (int s = 0; s < kTcStages - 1 && s < n_slabs; ++s)
        load_tc_slab(it0 + s, n_slabs, n_passes, slabs, frag, full);
    }
    float acc[kTcAcc];
#pragma unroll
    for (int i = 0; i < kTcAcc; ++i) acc[i] = 0.f;

    // Two sets of A registers, one for the slab whose products run while
    // the next slab's are issued.
    vm_tf32x3::FragA a0[kTcKSteps] = {}, a1[kTcKSteps] = {};
    for (int st = 0; st < n_slabs; st += 2) {
      tc_slab(it0 + st, st, n_slabs, n_passes, slabs, frag, full, xs, off, r0, r1, tq, a0, a1,
              acc);
      if (st + 1 < n_slabs)
        tc_slab(it0 + st + 1, st + 1, n_slabs, n_passes, slabs, frag, full, xs, off, r0, r1,
                tq, a1, a0, acc);
    }
    vm_tf32x3::wgmma_wait<0>();
    vm_tf32x3::fence_acc(acc);
    __syncthreads();  // every warp is done with the slabs

    // The pass's power over the spent slabs, re^2 + im^2 rounded op by op
    // as the plain version computes it: pass bin 4i + tq of frames 16w + g
    // and + 8, from accumulators 4i .. 4i + 3.
    float* power = slabs;
    const int fr = 16 * warp + g;
#pragma unroll
    for (int i = 0; i < kTcPassTiles; ++i) {
      power[fr * kTcPowerPitch + 4 * i + tq] = __fadd_rn(
          __fmul_rn(acc[4 * i], acc[4 * i]), __fmul_rn(acc[4 * i + 1], acc[4 * i + 1]));
      power[(fr + 8) * kTcPowerPitch + 4 * i + tq] = __fadd_rn(
          __fmul_rn(acc[4 * i + 2], acc[4 * i + 2]), __fmul_rn(acc[4 * i + 3], acc[4 * i + 3]));
    }
    __syncthreads();

    // Each filter's share of the pass's bins, in bin order, onto its sum:
    // over the passes, one walk of its band in order. Only the filters
    // [ma, mb) whose bands reach the pass's bins, a lane's filter for four
    // of its warp's frames at once (frames w + 4i).
    const int lo_p = kTcPassBins * pass, hi_p = lo_p + kTcPassBins;
    const int ma = bnd[3 * M + pass], mb = bnd[3 * M + n_passes + pass];
    for (int m0 = ma; m0 < mb; m0 += 32) {
      const int m = m0 + lane;
      const bool live = m < mb;
      const int lo = live ? max(bnd[m], lo_p) : 0, hi = live ? min(bnd[M + m], hi_p) : 0;
      const float* w = wts + (live ? bnd[2 * M + m] - bnd[m] : 0);
      for (int f = warp; f < kTcFrames; f += 4 * (kTcThreads / 32)) {
        constexpr int kStep = kTcThreads / 32;
        const float* p = power + f * kTcPowerPitch - lo_p;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        if (live) {
          s0 = mel[f * M + m], s1 = mel[(f + kStep) * M + m];
          s2 = mel[(f + 2 * kStep) * M + m], s3 = mel[(f + 3 * kStep) * M + m];
        }
        for (int k = lo; k < hi; ++k) {
          const float wk = w[k];
          s0 = fmaf(p[k], wk, s0);
          s1 = fmaf(p[k + kStep * kTcPowerPitch], wk, s1);
          s2 = fmaf(p[k + 2 * kStep * kTcPowerPitch], wk, s2);
          s3 = fmaf(p[k + 3 * kStep * kTcPowerPitch], wk, s3);
        }
        if (live) {
          mel[f * M + m] = s0, mel[(f + kStep) * M + m] = s1;
          mel[(f + 2 * kStep) * M + m] = s2, mel[(f + 3 * kStep) * M + m] = s3;
        }
      }
    }
    __syncthreads();  // the next pass's slabs overwrite the power
  }

  // The log; the tile's rows are contiguous in the output, so consecutive
  // threads store consecutively. (The last pass's barrier orders the sums.)
  const int valid = min(kTcFrames, n_frames - f0);
  float* dst = out + ((long long)b * n_frames + f0) * M;
  for (int idx = threadIdx.x; idx < valid * M; idx += kTcThreads)
    dst[idx] = logf(mel[idx] + log_eps);
}

// ---------------------------------------------------------------------------
// The FFT route
// ---------------------------------------------------------------------------

constexpr int kFftFramesPerWarp = 8;
constexpr int kFftTile = kWarps * kFftFramesPerWarp;  // frames a CTA (mel_fft.FRAME_TILE)

__device__ __forceinline__ int padded(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// R-point DFTs in registers, v[k] <- sum_r v[r] W_R^{rk}, op for op as
// mel_fft._butterfly: radix 8 as two radix-4s (even, odd points) and a W_8
// stage.
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
  const float2 a2 = cadd(v1, v3), a3 = mul_neg_i(csub(v1, v3));
  v0 = cadd(a0, a2);
  v1 = cadd(a1, a3);
  v2 = csub(a0, a2);
  v3 = csub(a1, a3);
}
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    const float r = 0.70710678118654752f;
    o1 = make_float2((o1.x + o1.y) * r, (o1.y - o1.x) * r);   // W_8
    o2 = mul_neg_i(o2);                                        // W_8^2 = -i
    o3 = make_float2((o3.y - o3.x) * r, -(o3.x + o3.y) * r);  // W_8^3
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// One Stockham pass of radix R over an NC-point complex FFT, NS points
// already combined: butterfly j reads points j + r·NC/R, twiddles point r
// by W_{NS·R}^{(j % NS)·r}, the pass's own table at (j % NS)·(R − 1) + r − 1
// (a lane's R − 1 twiddles adjacent, so the lanes' reads spread over the
// banks), transforms, and writes (j / NS)·NS·R + j % NS + r·NS. The first
// pass reads the frame from the waveform span, windowed and zero past win,
// not the buffer.
template <int NC, int R, int NS, bool FIRST>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw, const float2* wpair,
                                         const float* xf, int win, bool even_hop, int lane) {
  constexpr int kBf = NC / R;
  constexpr int kPer = (kBf + 31) / 32;
  float2 v[kPer][R];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = lane + 32 * q;
    if (kBf % 32 != 0 && j >= kBf) break;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * kBf;
      if constexpr (FIRST) {
        const int s = 2 * n;
        float2 z = make_float2(0.f, 0.f);
        if (s + 1 < win) {
          const float2 xv = even_hop ? *reinterpret_cast<const float2*>(xf + s)
                                     : make_float2(xf[s], xf[s + 1]);
          const float2 w = wpair[n];
          z = make_float2(xv.x * w.x, xv.y * w.y);
        } else if (s < win) {
          z.x = xf[s] * wpair[n].x;
        }
        v[q][r] = z;
      } else {
        v[q][r] = buf[padded(n)];
      }
    }
    if constexpr (NS > 1) {
      const int t = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], tw[t * (R - 1) + r - 1]);
    }
    dft<R>(v[q]);
  }
  __syncwarp();  // every lane has read before any lane writes
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = lane + 32 * q;
    if (kBf % 32 != 0 && j >= kBf) break;
    const int dst = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[padded(dst + r * NS)] = v[q][r];
  }
  __syncwarp();
}

// Entries of the passes' twiddle tables, NS·(R − 1) a pass after the first
// (mel_fft.fft_tables).
__host__ __device__ constexpr int twiddle_entries(int nc) {
  return nc == 32 ? 24 : nc == 64 ? 56 : nc == 128 ? 120 : nc == 256 ? 248 : 504;
}

// The passes of mel_fft.plan(NC); tw holds their twiddle tables in order.
template <int NC>
__device__ __forceinline__ void fft(float2* buf, const float2* tw, const float2* wpair,
                                    const float* xf, int win, bool even_hop, int lane) {
  if constexpr (NC == 32) {
    fft_pass<32, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<32, 4, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 64) {
    fft_pass<64, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<64, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 128) {
    fft_pass<128, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<128, 4, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<128, 4, 32, false>(buf, tw + 8 * 3, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 256) {
    fft_pass<256, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<256, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<256, 4, 64, false>(buf, tw + 8 * 7, wpair, xf, win, even_hop, lane);
  } else {
    static_assert(NC == 512, "nc must be a power of two in [32, 512]");
    fft_pass<512, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<512, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<512, 8, 64, false>(buf, tw + 8 * 7, wpair, xf, win, even_hop, lane);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
log_mel_fft_kernel(const float* __restrict__ x, const float2* __restrict__ tables,
                   const float* __restrict__ weights, const int32_t* __restrict__ bands,
                   float* __restrict__ out, int T, int n_frames, int n_tiles, int win,
                   int hop, int M, int n_weights, float log_eps) {
  constexpr int kTw = twiddle_entries(NC);
  constexpr int kTab = 2 * NC + 1 + kTw;
  constexpr int kBuf = NC + NC / 8;  // padded(NC)
  extern __shared__ __align__(16) float smem[];
  float2* tab = reinterpret_cast<float2*>(smem);  // window pairs | passes | W_N^k
  float2* bufs = tab + kTab;                       // one padded buffer a warp
  float* xs = reinterpret_cast<float*>(bufs + kWarps * kBuf);
  const int span = (kFftTile - 1) * hop + win;
  float* wts = xs + span + (span & 1);
  int* bnd = reinterpret_cast<int*>(wts + n_weights);

  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * kFftTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kTab; i += kThreads) tab[i] = tables[i];
  for (int i = threadIdx.x; i < n_weights; i += kThreads) wts[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M; i += kThreads) bnd[i] = bands[i];
  // The span read once; samples past the row (frames past n_frames) are 0.
  const float* row = x + (long long)b * T;
  const long long start = (long long)f0 * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long p = start + i;
    xs[i] = p < T ? row[p] : 0.f;
  }
  __syncthreads();

  const float2* wpair = tab;
  const float2* tw = tab + NC;
  const float2* split = tab + NC + kTw;
  float2* buf = bufs + warp * kBuf;
  float* power = reinterpret_cast<float*>(buf);
  const bool even_hop = (hop & 1) == 0;
  constexpr int kBins = NC / 32 + 1;  // bins k = lane + 32q <= NC of a lane

  for (int i = 0; i < kFftFramesPerWarp; ++i) {
    const int lf = warp * kFftFramesPerWarp + i;
    const int f = f0 + lf;
    if (f >= n_frames) break;  // warp-uniform
    fft<NC>(buf, tw, wpair, xs + lf * hop, win, even_hop, lane);

    // The split pass and the power; Z[NC] = Z[0], so bins 0 and NC are real.
    float pw[kBins];
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      const int k = lane + 32 * q;
      pw[q] = 0.f;
      if (k <= NC) {
        const float2 a = buf[padded(k & (NC - 1))];
        const float2 c = buf[padded((NC - k) & (NC - 1))];
        const float2 bc = make_float2(c.x, -c.y);  // Z*[NC - k]
        const float2 fe = make_float2((a.x + bc.x) * 0.5f, (a.y + bc.y) * 0.5f);
        const float2 fo = mul_neg_i(make_float2((a.x - bc.x) * 0.5f, (a.y - bc.y) * 0.5f));
        const float2 X = cadd(fe, cmul(split[k], fo));
        pw[q] = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      const int k = lane + 32 * q;
      if (k <= NC) power[k] = pw[q];
    }
    __syncwarp();

    // Each filter's band in bin order, then the log; the frame's M floats
    // are contiguous in the output.
    float* dst = out + ((long long)b * n_frames + f) * M;
    for (int m = lane; m < M; m += 32) {
      const int lo = bnd[m], hi = bnd[M + m];
      const float* w = wts + bnd[2 * M + m] - lo;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(power[k], w[k], acc);
      dst[m] = logf(acc + log_eps);
    }
    __syncwarp();  // the next frame's first pass overwrites the power
  }
}

template <int NC>
int launch_fft(const void* x, const void* tables, const void* weights, const void* bands,
               void* out, int B, int T, int n_frames, int win, int hop, int M, int n_weights,
               float log_eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fft_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + kFftTile - 1) / kFftTile;
  log_mel_fft_kernel<NC><<<(unsigned)B * n_tiles, kThreads, smem, stream>>>(
      (const float*)x, (const float2*)tables, (const float*)weights, (const int32_t*)bands,
      (float*)out, T, n_frames, n_tiles, win, hop, M, n_weights, log_eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T) f32; frag (n_passes, ksteps / kTcKSteps, kTcSlabFloats) f32:
// the bases' big and small tf32 planes, each pass's 208 columns as K-major
// core matrices (ops/mel_dft_tc.fragments); offs (8·ksteps,) int32: sample
// n of a frame at (n / hop)·pitch + n % hop in the span
// (ops/mel_dft_tc.column_offsets); weights: the filters' nonzero runs
// concatenated; bands (3·M + 2·n_passes) int32: each filter's first and
// one-past-last nonzero bin and the offset of its run, then for each pass
// the first and one-past-last filter whose band reaches its bins
// (ops/mel_dft_tc.band_weights); out (B, n_frames, M) f32. ksteps
// no multiple of kTcKSteps, more passes than 288 bins take, or a hop and
// window whose CTA does not fit shared memory (the rule of
// ops/mel_dft_tc.smem_bytes) returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int vm_log_mel_tc(const void* x, const void* frag, const void* offs,
                             const void* weights, const void* bands, void* out, int B, int T,
                             int n_frames, int ksteps, int hop, int M, int n_passes,
                             int n_weights, float log_eps, void* stream) {
  if (B == 0 || n_frames <= 0) return 0;
  if (ksteps < 1 || ksteps % kTcKSteps || hop < 1 || M < 1 || n_passes < 1 ||
      n_passes > kMaxPasses || n_weights < 0)
    return (int)cudaErrorInvalidValue;
  const int pitch = hop + (4 - hop % 8 + 8) % 8;
  const int n_rows = kTcFrames + (8 * ksteps - 1) / hop;
  const size_t smem = 4 * (32 + (size_t)kTcStages * kTcSlabFloats + (size_t)kTcFrames * M +
                           (size_t)n_weights + 3 * (size_t)M + 2 * (size_t)n_passes +
                           8 * (size_t)ksteps +
                           (size_t)n_rows * pitch);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + kTcFrames - 1) / kTcFrames;
  log_mel_tc_kernel<<<(unsigned)B * n_tiles, kTcThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)frag, (const int32_t*)offs, (const float*)weights,
      (const int32_t*)bands, (float*)out, T, n_frames, n_tiles, hop, pitch, n_rows, ksteps,
      n_passes, M, n_weights, log_eps);
  return (int)cudaGetLastError();
}

// x (B, T) f32; tables (2·nc + 1 + twiddle_entries(nc), 2) f32: the window
// pairs (w[2n], w[2n+1]) with zeros past win, each pass's twiddles
// W_{NS·R}^{t·r} at t·(R − 1) + r − 1, W_N^k for k <= nc (nc = n_fft / 2 =
// 1 << log_nc); weights: the filters' nonzero runs concatenated; bands
// (3, M) int32: each filter's first and one-past-last nonzero bin and the
// offset of its run; out (B, n_frames, M) f32. An nc with no instance here,
// or a geometry whose CTA does not fit shared memory (the rule of
// ops/mel_fft.smem_bytes), returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int vm_log_mel_fft(const void* x, const void* tables, const void* weights,
                              const void* bands, void* out, int B, int T, int n_frames, int win,
                              int hop, int M, int n_weights, int log_nc, float log_eps,
                              void* stream) {
  if (B == 0 || n_frames <= 0) return 0;
  if (log_nc < 5 || log_nc > 9 || win > (2 << log_nc)) return (int)cudaErrorInvalidValue;
  const int nc = 1 << log_nc;
  const int span = (kFftTile - 1) * hop + win;
  const size_t smem = 8 * (size_t)(2 * nc + 1 + twiddle_entries(nc)) +
                      8 * (size_t)kWarps * (nc + nc / 8) +
                      4 * (size_t)(span + (span & 1)) + 4 * (size_t)n_weights + 12 * (size_t)M;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_nc) {
    case 5:
      return launch_fft<32>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                            n_weights, log_eps, smem, s);
    case 6:
      return launch_fft<64>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                            n_weights, log_eps, smem, s);
    case 7:
      return launch_fft<128>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
    case 8:
      return launch_fft<256>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
    default:
      return launch_fft<512>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
  }
}
