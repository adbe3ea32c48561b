"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root, on a machine with a CUDA card and ``nvcc``.
Each phase prints one JSON line; nothing here imports JAX.

1. device — exit non-zero without CUDA; print the ``nvidia-smi`` name and
   power limit;
2. build — compile ``voicemap_tpu_torch/csrc`` for ``sm_90a``;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge shapes, with the tolerance stated,
   the launch counters read around the phase: B1; B2's tensor-core kernel
   (every bf16 GEMM) in f32 out within its order bound, bf16 out within that
   bound before its rounding and by row cosine, int8 out by the flip rule,
   at B = 256 and 1, T % 4 != 0 with C = 16 and 160, rows of very different
   scale and B = 70000, and its f32-GEMM kernel bit for bit; B3 at the three
   config #1 block shapes and at edges (odd T, T no tile multiple, Couts 40,
   72, 100 and 75, Cin = 480 and 512, B = 1 at each block shape, rows of very
   different scale); B8 at the same three shapes in f32 output (each output
   within a bound derived from its K = k·Cin products and f32 rounding) and
   bf16 output (row cosine), and at edges (odd T, T = 2 and 3, B = 1 at each
   block shape, T no tile multiple, k = 5, Cin = 40, Couts 24, 72, 100 and 75,
   rows scaled by 1, 1e3 and 1e-3, BN scales of both signs); B10's mma and
   pool stages exactly against their plain versions and its full stage equal
   to B3, at the three shapes; B3 (bit for bit) and B8 (as above) at config
   #3's seven dilated and pool-1 block shapes, at B = 1 at each and at
   DILATED_EDGES (d = 16 at T = 375 and below the reach, pool 1 with odd T,
   Couts 72, 100 and 75, f32 out at pool 1, rows of very different scale),
   the record's ``dilated_checks``;
   train kernels — B4 and B5 on the tensor cores at the train step's
   (32, 12000, 128) and at B45_EDGES (T/4 no tile multiple, C = 72, 16 and
   256, B = 1, rows of very different scale, exact ties): a_sel within its
   order bound (f32 out) and that bound before its rounding and a row cosine
   (bf16 out), #(a > 0) and B5's routing flipping only within the bound,
   the statistics, dW and db to 1e-4 of their largest value, B5's
   recomputed selection (its stage entry) equal to B4's a_sel bit for bit;
   B5 at the inputs of seed 0's train step, its dW and db to 1e-4 against
   the plain ones on the routes and relu masks B5 took, the flips counted;
   their f32 route (the conv and B5's dW in 3xTF32 on the tensor cores) at
   (2, 4100, 72), at (48, 12000, 128) (more items than CTAs), on rows of
   very different scale and on the ties grid: the same rules at the 3xTF32
   unit (a_sel in f32 and bf16 out, #(a > 0), B5's routes and relu masks,
   the flips counted), the statistics to 1e-4, dW and db to 1e-4 on B5's
   own routes and masks, B5's selection equal to B4's f32 a_sel bit for bit;
   B7's pool and routing passes (on a raw conv output and its bias,
   channels last, the cotangent in f32) at the three config #1 block shapes
   of the train step and at ROUTING_EDGES (C = 67 with odd T/pool, pool 4
   in f32, B = 1, rows of very different scale, forced ties, pool 3, 257
   channel vectors, and pool 1 at config #3's train shapes), a_sel and dz
   bit for bit, each against its plain version; B7's phase-index mode at
   the same shapes and edges (and an f32 activation with a bf16 selection,
   as the pool-rate-residual forward pools), a_sel, idx and dz bit for bit,
   the selection equal to the value mode's; B3's train epilogue (the int8
   training forward's conv, on operands from the in-step quantize pass) at
   config #1's three block shapes (CHECK_ROWS rows, bf16 out; f32 out at
   the train step's batch), at config #3's seven dilated and pool-1 blocks
   and at QTRAIN_EDGES (B = 1, T odd, Cin = 32, Couts 72, 100 and 75, d =
   16 below the reach, f32 out), bit for bit; B8 at pool 1 with f32 output
   and rows (b, 1, 0), the pool-rate-residual forward's conv, at the three
   train block shapes within ``blockn_bound``; the launch counters read
   around the phase;
4. slice — config #1 at full width (filters 128, embedding 64, 3 s at 16 kHz,
   downsampling 4) built from a flax-layout tree through ``from_flax``,
   serving 500 1-shot 5-way n-shot tasks over a seeded synthetic store in
   bf16 (B1 → B2 → B8 × 3), with the kernels' launch counters read around
   that run and its embedding table held against the plain-version path
   (cuDNN for every block);
5. int8 slice — the same model calibrated with ``quantize_from_store`` and
   served in int8 (B1 → B2 with requant → B3 × 3), the same 500 tasks, its
   launch counters read around that run, its table held against the
   plain-version int8 path and set beside the bf16 table;
6. int8 fidelity gate — as ``bench.py`` does it: calibrate on bench-store rows
   [0, 256), embed rows [256, 512) at fresh offsets in int8 and in bf16, and
   require a min cosine ≥ 0.999;
7. train slice — ``fit`` at full config #1 width, batch 32, for 40 steps on
   the seeded 40-speaker store with an n-shot evaluation at the end, the
   launch counters read around it and the evaluation's own launches counted
   apart: per step B1 1, B4 1, B5 1, B7 3 + 3; the evaluation, on the model's
   own forward as the reference's fit, B1 only; no fused block's backward
   copies its cotangent into the channels-last layout; every loss finite
   and the last five below the first five; then one step from fixed weights and a
   fixed batch through the kernels and through their plain versions,
   held together (loss, gradient cosine per parameter);
7b. int8 train slice — the same ``fit`` with ``quant_forward="int8"``
   (``fused_int8``): per step B1 1, B4 1, B5 1, B3's train epilogue 3, B7
   3 + 3 (value mode, on the dequantized activation); the evaluation B1
   only; losses finite and falling; one step through every kernel against
   every plain version reported in f32 and bf16, and through B3's train
   epilogue alone and B7 alone (the rest plain) held in both;
7c. recompute train slice — 40 steps at batch 32 through
   ``classifier_train_forward(blockn="fused_recompute")`` with the port's
   optimizer (no config resolves to it): per step B1 1, B4 1, B5 1, B8 3
   (pool 1, f32 out), B7's index mode 3 + 3; losses finite and falling;
   one step held against its plain-version step in f32 and bf16;
7d. raw store slice — ``fit`` for RAW_STEPS steps with
   ``use_pallas_preprocess=False``: the store raw, each batch through the
   plain chain (offsets over the raw fragment, gather, ÷ 32768, decimation,
   whitening), B1 0 in training and in the evaluation; the chain's batch on
   the card against the same chain on the CPU on the same offsets (max abs
   ≤ 1e-6); at offset 0 the raw store's batch against the decimated
   store's (B1), within B1's own tolerance;
8. timing — CUDA-event times of each kernel beside its plain version, its
   bound and (B2) ``F.conv1d`` at (B, 1, T), (B3) a library GEMM; B8 per block beside its bound, its plain
   version, ``F.conv1d`` (conv and bias only) and the cuDNN block it
   replaced; the bf16 embed's stages (``stage_profile``); embed throughput
   at B=2048 in bf16 and int8, and bf16 through B8 against the cuDNN chain
   in turns; batch-1 latency; int8 against bf16 embed time over batch sizes;
8b. attribution — ``utils/qblock_attrib``: B10's stages and B3 at config
   #1's three block shapes, B=2048, ms, increments and TOP/s, the launch
   counters read around it; the mma stage beside its plain version and bound;
9. train timing — B4, B5 (both routes, queued: the device's time alone,
   and back to back) and B7 beside their bounds, plain versions and (B5) a
   library weight-gradient conv at the train step's shapes, B4, B5 and B7
   also at B=2048 beside their bounds;
   on an earlier line (train_layout) the fused step at B=2048 under the
   profiler, with the device ms of cuDNN's NCHW↔NHWC conversions; the train
   step's ms and utt/s at B=32 and B=2048 under the four blocks-1+
   policies (jnp, fused, fused_recompute, fused_int8), in turns (the four,
   then the four backwards), peak memory, and each policy's idle share
   under the profiler; B3's train epilogue per block at B=2048 beside its
   bound, its plain version and ``torch._int_mm`` on the patch matrix; B7's
   index mode per block at the train step's batch beside its bound and
   plain version;
9b. config #3 (``dilated_4khz``: eight blocks, pools 4, 1, 2, 1, 2, 1, 2,
   1, dilations 1, 2, 1, 4, 1, 8, 1, 16) at full width from a flax-layout
   tree: dilated_slice, the same 500 tasks in bf16 (B1 → B2 → B8 × 7),
   launch counters around it, the table against the plain-version path;
   dilated_int8_slice (``quantize_from_store``, B1 → B2 requant → B3 × 7),
   against the plain int8 path and beside bf16; dilated_int8_fidelity,
   bench.py's gate printed with ``int8_served`` and, as bench.py does,
   bf16 served where it fails, not held; dilated_train_slice, ``fit`` for
   40 steps at batch 32 (per step B1 1, B4 1, B5 1, B7 7 + 7; the
   evaluation B1 only), losses falling, one step held against its
   plain-version step in f32 and reported in bf16; dilated_timing, B8 and
   B3 per block at B=2048 beside bounds, plain versions and library calls
   (``F.conv1d`` with the dilation, ``torch._int_mm`` on the dilated patch
   matrix), both embeds' utt/s, batch-1 latency, peak memory and stages,
   the train step at B=32 and 2048 under both blocks-1+ policies, and
   cuDNN's dilated convs per block (NHWC as the train step runs them, also
   autotuned, beside NCT); the train slice's launches also hold
   ``conv_wgrad`` once a dilated block a step (4 on config #3, 0 on #1);
9c. wgrad kernels — ``conv_wgrad``, the dilated convs' weight gradient in
   training, at config #3's four dilated blocks (d 2, 4, 8, 16) at
   TRAIN_BATCH, CHECK_ROWS and BATCH rows against float64 sums (each dW
   within TRAIN_REL_TOL of its largest element) and repeated bit for bit, the launch counters read
   around it; then per block at B=BATCH beside its bound (x and dz read
   once in bf16, dW written once in f32, the conv's FLOPs at the bf16
   rate), its plain version and cuDNN's wgrad alone
   (``aten.convolution_backward`` with output mask [False, True, False] on
   the NHWC views);
10. mel kernels — config #4's: B1 at downsampling 1, frag 48000, over the
    bench store undecimated; B6's FFT kernel against its plain version (and
    against the rfft route) on 256 whitened 48000-sample fragments at
    config #4's geometry and at edge shapes (the librosa hop 160 / win 400,
    n_mels 32, B = 1 and 5, T = 47999 and 30001, one frame, n_fft 256 and
    1024, a tone, a zero row, rows × 1e3 and 1e-3), its DFT kernel (3xTF32
    on the tensor cores) at n_fft 400 with win 400 / hop 160 and win 320 /
    hop 100, B = 1, 3, 5, T = 30001, at n_fft 255 with win 200, and on the
    special rows, the launch counters read around the phase;
11. mel slice — config #4 (``melspec_2d``: log-mel + 2D CNN, filters 128,
    embedding 64, 3 s at 16 kHz, downsampling 1) at full width from a
    flax-layout tree, the same 500 tasks over the same store in bf16 (B1 →
    B6 → cuDNN 2D convs), launch counters around the run, its table held
    against the plain-version path;
12. mel int8 slice — ``quantize_from_store``, the same 500 tasks with the
    mel qvars (B1 → B6 → int8 patch-matrix convs), launch counters around
    the run, the table held against the plain-version int8 path; the min row
    cosine of int8 against bf16 on held-out bench rows, held ≥ 0.99;
13. mel timing — B6 at B=2048 on both routes (config #4's FFT, the DFT at
    n_fft 400) beside its bound (the function's bytes and its rfft
    operations), the floors of the DFT-as-matmul algorithm at the TF32 and
    f32 rates and in 3xTF32, its plain version and ``torch.stft`` (spectrum
    only); config
    #4 embed utt/s
    at B=2048, batch-1 latency and peak memory, in bf16 and in int8;
13b. asp kernels — ECAPA-TDNN's attentive statistics pooling (ASP,
    ``ops/cuda_asp``), both modes at the ECAPA cell's shape (2,048 × 298 ×
    3,072, bf16, logits over ±60 rising in T) within their f32 summation
    bound of float64 (the plain versions' readings beside), the difference
    from the plain versions reported, a second launch equal bit for bit,
    the launch counters read around it; ``ecapa.fast_embed`` on 16 windows
    at the preset's widths (B6 1, B8 30, ASP 1 + 1) against the same
    forward with ASP's plain versions (row cosine); both modes beside their
    bytes bound and the plain versions; the backward (both modes, the
    autograd functions' one kernel pass each) at the ECAPA training cell's
    batch (512 × 298 × 3,072, bf16): each utterance's dh and dlogits within
    2^-8 of float64 autograd through the plain versions' formula (relative
    to the row's norm), a second backward equal bit for bit, the weighted
    mode's training instantiation's output equal bit for bit to the
    inference launch's and its saved softmax max and sum against the
    logits' (the max equal, the sum within 6γ_n of float64), its launches
    counted, then timed beside its bytes bound and the eager autograd;
13c. ecapa train — one ``make_ecapa_train_step`` at ECAPA-TDNN's preset
    widths and the training cell's batch (512 windows of 3 s at random
    offsets from a seeded store at downsampling 1), the launch counters set
    to 0 just before and read just after: B1 1, B6 1 (its DFT route), ASP's
    training forward 1 in each mode and its backward 2 (one a mode), and
    nothing else of ``csrc/`` (each training TDNN is cuBLAS's or cuDNN's);
    the loss finite;
14. siamese kernels — B9 against its plain version, bit for bit, at
    (T, nq, ns, D) = (1, 4096, 4096, 64), the n-shot form (500, 1, 5, 64) and
    edges ((1, 33, 41, 64), (1, 1, 1, 64), (3, 7, 130, 17), D at its
    maximum in both forms), w of both signs, b != 0;
15. siamese slice — config #2 (``siamese_verification`` with
    ``weighted_l1``: filters 128, embedding 64, dropout 0, 3 s at 16 kHz,
    downsampling 4) at full width from a flax-layout tree, the same 500
    tasks over the same store scored by the head in bf16 (B1 → B2 → B8 × 3,
    B9) and in int8 (B1 → B2 requant → B3 × 3, B9), 1,000 verification
    pairs → EER and AUC (B9), and ``score_support`` of the table against
    itself (B9), the launch counters read around each run, each table held
    against its plain-version path and each set of B9 scores against the
    plain version's;
16. siamese train slice — ``fit`` on config #2 with ``weighted_l1`` (BCE),
    batch 64 pairs, 40 steps, the evaluation's launches counted apart: per
    step B1 2, B4 1, B5 1, B7 3 + 3; the evaluation B1 and B9 only; losses
    finite and falling; then one BCE
    and one contrastive step through the kernels and through their plain
    versions, held together;
17. siamese timing — B9 at both shapes beside its bound, its plain version,
    the broadcast form and ``torch.cdist`` (the library call for w >= 0),
    B9 back to back and queued, and the host microseconds of a call of its
    wrapper and of ``cdist``;
    the 500-task head scoring; the siamese train step at batch 64 pairs
    under the auto policy, with peak memory, and its layout conversions
    under the profiler;
18. mel train slice — ``fit`` on config #4 (``melspec_2d``) at full width
    (filters 128, embedding 64, dropout 0.05, 3 s at 16 kHz, downsampling 1),
    batch 64, 40 steps on the same store, the evaluation's launches counted
    apart: per step B1 1, B6 1 (cuDNN's 2D convs; no gradient reaches B6),
    the evaluation B1 and B6 only; losses finite and falling; then one step
    from fixed weights and a fixed batch through the kernels and through
    their plain versions, held in f32 and reported in bf16;
19. mel train timing — config #4's train step at B=64 and 2048: ms, utt/s,
    peak memory, the device's idle share under the profiler;
20. corpus slice — the port's ``generate_corpus`` writes a FLAC corpus in
    LibriSpeech's layout (two subsets of 20 speakers × 5 utterances of
    3.1-4.0 s) into a temporary directory, timed; ``fit(cfg)`` with no
    store trains config #1 at full width from it, batch 32, 40 steps,
    through the device pipeline (per step B1 1, B4 1, B5 1, B7 3 + 3) and
    the streaming pipeline (B4 1, B5 1, B7 3 + 3, B1 0), each evaluated on
    the validation subset at ``stochastic=False`` (B1 only, counted apart),
    losses finite and falling; config #2 (``weighted_l1``, BCE) 10 streaming
    steps of 64 pairs (B4 1, B5 1, B7 3 + 3; its evaluation B1 and B9); the
    host's FLAC decode rate (``read_batch``, the decode cache cold and warm)
    and the streaming step against the device-pipeline step at B=32 and
    2048 (utt/s, peak memory, idle share);
21. streaming embed — on that corpus, ``embed_all_streaming`` against
    ``embed_all`` on the device store of the same dataset, row for row (min
    cosine ≥ 0.999), the launch counters read around the streamed run:
    config #1 bf16 (B2 → B8 × 3), int8 with qvars from
    ``quantize_from_frags`` on the first 256 offset-0 fragments (B2 requant
    → B3 × 3), config #4 (B6); no B1 on the streamed runs;
22. protocol slice — the five experiment CLIs (``voicemap_tpu_torch/
    experiments``) in-process at their full config #1 and #2 widths on a WAV
    corpus the port's ``generate_corpus`` writes (train-clean-100 of 20
    speakers × 10 utterances, dev-clean and test-clean of 12 × 8, 3.1-4.0 s),
    each command's launches counted and held: ``train_classifier`` at batch
    32 to a soak checkpoint, then resumed in its directory (``resumed from
    step``); ``evaluate --protocol`` on it in bf16 (B1, the model's forward)
    and ``--int8`` (B1 → B2 requant → B3 × 3), the manifest's six records
    each on the replayed JAX key stream, in form; ``--int8-gate``, the int8
    decision gate's verdict and checks, reported, not held; ``--k-sweep
    --fast --verification`` (B1 → B2 → B8 × 3), the points past 12 speakers
    skipped; ``train_siamese`` (``weighted_l1``) and its protocol, scored by
    the head (B9); ``embed --int8 --save-qvars`` and ``embed --qvars``,
    equal tables; ``visualize_embeddings``' ``.npz``; the replay's host ms
    at the manifest's settings and one batch-1 request through the
    checkpoint (``single_request_latency``);
23. pod slice — config #5 (``parallel/pod_eval``) at world size 1 in an
    NCCL process group (``HashStore``; destroyed after the phase), on a
    synthetic stand-in for test-clean (POD_STORE: 40 speakers × 66
    utterances of 3.5-11.5 s, the counts not the manifest's):
    ``pod_evaluate`` in bf16 (B1, the model's forward) and int8 (the
    fidelity gate's qvars: B1 → B2 requant → B3 × 3) at the manifest's four
    entries' (n, k), 500 tasks each on its ``task_seed`` key, and config
    #2's net scored by its head (B1, B9), each path's launches held and
    each accuracy equal to the single-device ``nshot.evaluate``'s; the pod
    table equal to ``embed_all``'s; ``sharded_sq_euclidean``,
    ``ring_sq_euclidean`` and ``sharded_nearest_support`` equal to
    ``pairwise_sq_euclidean`` over the 2,640-row table; the table's embed
    time and utt/s, the scorer's ms at 500 and 20,000 tasks, the
    ``all_gather`` and ``all_reduce`` ms, peak memory;
24. dp slice — data-parallel training (``parallel/data_parallel``) at world
    size 1 through NCCL: ``make_dp_classifier_train_step`` for 40 steps at
    batch 32 on config #1 at full width (per step B1 1, B4 1, B5 1, B7 3 +
    3), losses finite and falling; one DP step held against the
    single-device step on the same draw (loss and gradient cosines, as the
    plain-version steps are held); ``fit(dp="on")`` at world size 1 warns
    and trains unsharded (its launches held); the DP step's ms and utt/s
    against the single-device step's in turns (single, dp, dp, single);
25. mesh slice — sequence, tensor and pipeline parallelism
    (``parallel/{halo_conv,dp_sp,tensor_parallel,pipeline_parallel}``).
    First, in-process at world size 1 through NCCL, each program whose mesh
    admits one rank against its single-device counterpart (sp at seq 1,
    dp_sp at 1 × 1, tp at model 1, GPipe at S = 1) and the real-encoder
    pipeline's refusal at pp 1. Then MESH_WORLD = 6 ranks, all on the one
    card, in a gloo group whose collectives stage through the host
    (``parallel/comm``), on a file rendezvous under ``build/``, their stdout
    gathered: sp, ``make_sharded_embed_fn`` on config #3 in f32 over seq 3 of
    {data 2, seq 3}, against the dense forward to 1e-4 relative; dp_sp, one
    config #3 step at its batch (64) on the same mesh at dropout 0 (B1 1 a rank),
    against the single-device full-batch step on the same draws (loss to
    1e-5, every gradient's and new running statistic's cosine ≥ 0.99999),
    and one at the config's dropout reported; tp,
    ``make_tp_encoder_embed_fn`` on config #1 in bf16 over {data 3, model 2}
    (B2 1, B8 3 a rank), against the f32 Dense on ``fast_trunk``'s output to
    1e-5, and ``make_tp_mlp`` against the dense product; pp and pp-bwd,
    GPipe with the six ranks as stages against the stages in turn; pp-real,
    the two-stage real encoder on ranks 0 and 1, eval in bf16 (B2 on stage 0,
    B8 on stage 1) against ``fast_embed`` per microbatch, train in f32
    against sequential autograd (loss 1e-5, gradients 1e-4, the chained
    statistics 1e-5); the dry run's nine-field line from rank 0; each
    program's ms, the bytes and ms staged through the host, peak memory a
    rank (one card shared by six ranks over host transport: not collective
    costs across cards);
    then the run's total seconds.

It ends with the per-kernel summary line, then
``{"ok": true, "device": {...}}``. Any failed phase raises, so the exit code
is non-zero and that last line is never printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

# Published H100 SXM peaks (NVIDIA's data sheet, dense rates): one yardstick
# for these timers and the benchmark.
from portbench.counts import (
    BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, TF32_OPS_PER_S,
)
from voicemap_tpu_torch import _build
from voicemap_tpu_torch.config import (
    EncoderConfig, MelConfig, SiameseConfig, classifier_baseline, dilated_4khz, ecapa_tdnn,
    melspec_2d, siamese_verification,
)
from voicemap_tpu_torch.data import flac_ext
from voicemap_tpu_torch.data.dataset import dataset_from_config
from voicemap_tpu_torch.data.pipeline import DecodeCache, StreamingPipeline, iter_embed_batches
from voicemap_tpu_torch.data.store import synthetic_store
from voicemap_tpu_torch.data.synthetic import SyntheticSpec, generate_corpus
from voicemap_tpu_torch.eval import nshot, verification
from voicemap_tpu_torch.eval.protocol import load_manifest
from voicemap_tpu_torch.experiments import (
    embed as embed_cli, evaluate as evaluate_cli, restore_model,
    train_classifier as train_classifier_cli, train_siamese as train_siamese_cli,
    visualize_embeddings as visualize_cli,
)
from voicemap_tpu_torch.models.classifier import SpeakerClassifier
from voicemap_tpu_torch.models.convert import from_flax
from voicemap_tpu_torch.models.encoder import ConvEncoder
from voicemap_tpu_torch.models import ecapa, fused_train
from voicemap_tpu_torch.models.fast_infer import fast_embed, fast_trunk, takes_blockn
from voicemap_tpu_torch.models.quant_infer import (
    quant_embed, quant_embed_mel, quantize_encoder, quantize_from_frags, quantize_from_store,
    quantize_mel_encoder,
)
from voicemap_tpu_torch.models.siamese import SiameseNet
from voicemap_tpu_torch.models.spectrogram import MelSpecClassifier
from voicemap_tpu_torch.ops import (
    block0_tc, block0_train_tc, cuda_conv, cuda_conv_train, cuda_distance, cuda_melspec,
    cuda_quant_block, cuda_routing, cuda_wgrad, melspec, preprocess, sampling,
)
from voicemap_tpu_torch.ops import distance as dist_ops
from voicemap_tpu_torch.ops import jax_random
from voicemap_tpu_torch.parallel import (
    comm, data_parallel, distributed, dp_sp, dryrun, halo_conv, pipeline_parallel, pod_eval,
    sharded_distance, tensor_parallel,
)
from voicemap_tpu_torch.parallel.mesh import data_mesh, make_mesh
from voicemap_tpu_torch.ops.cuda_conv import (
    bn_affine, conv_block0, conv_block0_reference, conv_blockn, conv_blockn_reference,
    conv_blockn_rows, conv_blockn_rows_reference,
)
from voicemap_tpu_torch.ops.cuda_asp import (
    STAT_EPS, asp_stats, asp_stats_bytes, attentive_stats_reference, global_stats_reference,
)
from voicemap_tpu_torch.ops.cuda_distance import (
    MAX_D, weighted_l1, weighted_l1_reference, weighted_l1_work,
)
from voicemap_tpu_torch.ops.cuda_melspec import log_mel, log_mel_reference, log_mel_work
from voicemap_tpu_torch.ops.cuda_conv_train import (
    bwd_dz, conv_block0_train, conv_block0_train_bwd, conv_block0_train_bwd_reference,
    conv_block0_train_bwd_routed_reference, conv_block0_train_bwd_stage,
    conv_block0_train_bwd_stage_reference, conv_block0_train_reference, relu_bits,
)
from voicemap_tpu_torch.ops.cuda_preprocess import (
    decimate_store, gather_whiten, gather_whiten_reference,
)
from voicemap_tpu_torch.ops.cuda_quant_block import (
    STAGES, quant_block, quant_block_reference, quant_block_stage, quant_block_stage_reference,
    quant_block_train, quant_block_train_reference,
)
from voicemap_tpu_torch.ops.conv_train import FusedBlocknTrain, quantize_int8, wgrad_routed
from voicemap_tpu_torch.ops.cuda_wgrad import conv_wgrad, conv_wgrad_reference
from voicemap_tpu_torch.ops.cuda_routing import (
    bn_apply, bn_apply_reference, bn_grad, bn_grad_reference, is_channels_last, pool_fwd,
    pool_fwd_reference, route_bwd, route_bwd_reference,
)
from voicemap_tpu_torch.train import losses as train_losses
from voicemap_tpu_torch.train import steps
from voicemap_tpu_torch.train.loop import fit, init_model
from voicemap_tpu_torch.train.state import init_state
from voicemap_tpu_torch.train.steps import DeviceStore, device_store_for, fetch_batch
from voicemap_tpu_torch.utils import qblock_attrib, stage_profile
from voicemap_tpu_torch.utils.profiling import single_request_latency, throughput, time_fn

DEVICE = "cuda"  # every tensor of the run lives here
# The store that bench.py measures: 2048 rows of 3.5 s raw int16, decimated
# once; 12000-sample fragments at decimated offsets in [0, 2000].
BATCH = 2048
STORE_T = 56000
DS = 4
FRAG = 12000
CHECK_ROWS = 256  # rows of the on-card checks and of each plain-version chunk
# Config #1's blocks 1-3: (T in, Cin, Cout, last), int8 (B3) and bf16 (B8, k = 3).
QBLOCKS = ((3000, 128, 256, False), (1500, 256, 384, False), (750, 384, 512, True))
# B8's edges: (B, T, Cin, Cout, k). The kernel's tiles are 256 (or 128)
# conv rows by 128 channels and it stores 8 channels at a time: T = 1001 and
# 257 end in a partial tile, Couts 24, 72, 100 and 75 in a partial channel
# tile (100 and 75 no multiple of 8, 75 odd), Cin = 40 pads its tap's run.
B8_EDGES = ((3, 1001, 128, 256, 3), (1, 2, 128, 64, 3), (2, 3, 64, 72, 3),
            (1, 300, 128, 128, 5), (2, 257, 40, 24, 3), (2, 130, 384, 512, 3),
            (2, 301, 64, 100, 3), (3, 513, 128, 75, 3))
# Config #3's (dilated_4khz) blocks 1-7: (T in, Cin, Cout, pool, dilation,
# last), int8 (B3) and bf16 (B8, k = 3), at the bench store's 12000-sample
# fragments (3 s at 16 kHz decimated by 4).
DILATED_BLOCKS = ((3000, 128, 128, 1, 2, False), (3000, 128, 256, 2, 1, False),
                  (1500, 256, 256, 1, 4, False), (1500, 256, 384, 2, 1, False),
                  (750, 384, 384, 1, 8, False), (750, 384, 512, 2, 1, False),
                  (375, 512, 512, 1, 16, True))
# B3's and B8's edges at dilation (B, T, Cin, Cout, pool, dilation, out of
# B3's last block or None): d = 16 at T = 375 with Cout 72; T below the
# reach 2d (20 and 31 at d = 16); pool 1 with odd T and Couts 100 and 75;
# pool 2 at a dilation with odd T; f32 out at pool 1 (the ring's 2 stages).
DILATED_EDGES = ((2, 375, 512, 72, 1, 16, None), (3, 20, 64, 72, 1, 16, None),
                 (2, 31, 64, 100, 1, 16, torch.bfloat16), (3, 1001, 128, 100, 1, 2, None),
                 (2, 1001, 96, 75, 1, 4, torch.bfloat16), (2, 301, 128, 72, 2, 8, None),
                 (2, 301, 64, 72, 1, 8, torch.float32))
# B2's edges: (B, T, C): T % 4 != 0, C = 16 and 160 (no multiple of the
# kernel's 32-channel slice); and more rows than a launch's grid.y takes.
B2_EDGES = ((3, 1001, 16), (2, 4098, 160))
B2_WIDE = (70000, 64, 16)
# Rows of very different scale, so that a read across the batch-row
# boundary (row t < 0 or t >= T taken from the neighbouring row) shows.
ROW_SCALES = (1.0, 1e3, 1e-3)
SWEEP = (1, 8, 64, 256, 2048)
# The synthetic store every slice serves and trains on: 40 speakers x 8
# utterances of 3.5-6 s.
SLICE_STORE = dict(n_speakers=40, utterances_per_speaker=8, min_seconds=3.5, max_seconds=6.0)
# The train step of config #1: batch 32 of 12000 samples; block 0's width;
# blocks 1-3's full-rate conv outputs (C, T), pool 2; train steps of the slice.
TRAIN_BATCH = 32
TRAIN_C0 = 128
TRAIN_BLOCKS = ((256, 3000), (384, 1500), (512, 750))
TRAIN_STEPS = 40
TRAIN_TIMING_BATCHES = (32, 2048)
# B4/B5's edges (B, T, C, rows), the bf16 route: T/4 = 250 (no multiple of
# the 64- or 16-position tile), C = 72 and 16 (padded to the 32-channel
# slice) and 256 (two channel groups; the widest the kernels take), B = 1
# (16-position tiles so the items reach the SMs), rows × 1, 1e3, 1e-3, and x
# and w on coarse grids with silent stretches, so that sums are exact in any
# order and phases tie exactly (the route goes to the first).
B45_EDGES = ((3, 1000, 128, "plain"), (2, 1000, 72, "plain"), (2, 1000, 16, "plain"),
             (2, 1000, 256, "plain"), (1, 12000, 128, "plain"), (3, 1000, 128, "scaled"),
             (2, 1000, 72, "ties"))
# The f32 route at an edge: C = 72, T/4 = 1025; at more items than its
# grid's CTAs (48 rows of 47 items of 64 positions against 396), so that
# CTAs walk several items and B5's dW accumulators carry across them before
# the fold; and, as B45_EDGES has for bf16, rows × 1, 1e3, 1e-3 and the
# coarse grid where phases tie exactly (B, T, C, rows).
B45_F32_EDGE = (2, 4100, 72)
B45_F32_WIDE = (48, 12000, 128)
B45_F32_ROWS = ((3, 1000, 128, "scaled"), (2, 1000, 72, "ties"))
# The train step whose inputs B5's dW is held at on its own routes: the
# step of step_attrib.py (compare_plain_step) at this seed.
B5_STEP_SEED = 0
# B7's edges (B, C, T, pool, dtype, rows): C = 67 (no multiple of 8: one
# channel a thread) with odd T/pool, pool 4 in f32 on both widths, B = 1,
# rows × 1, 1e3, 1e-3, forced ties, pool 3 (the any-pool path on vectors),
# and C = 2056 (257 vectors: a second column chunk of CTAs); then pool 1 at
# config #3's train shapes of its dilated blocks 1, 3, 5 and 7 (B = 32), one
# on rows of very different scale.
ROUTING_EDGES = ((5, 67, 250, 2, torch.bfloat16, "plain"),
                 (3, 67, 1000, 4, torch.float32, "plain"),
                 (2, 384, 1000, 4, torch.float32, "plain"),
                 (1, 256, 3000, 2, torch.bfloat16, "plain"),
                 (4, 256, 602, 2, torch.bfloat16, "scaled"),
                 (3, 128, 512, 2, torch.bfloat16, "ties"),
                 (2, 72, 96, 3, torch.bfloat16, "ties"),
                 (2, 2056, 64, 2, torch.bfloat16, "plain"),
                 (32, 128, 3000, 1, torch.bfloat16, "plain"),
                 (32, 256, 1500, 1, torch.bfloat16, "scaled"),
                 (32, 384, 750, 1, torch.bfloat16, "plain"),
                 (32, 512, 375, 1, torch.bfloat16, "plain"))
# B3's train epilogue's edges (B, T, Cin, Cout, dilation, out dtype): B = 1
# at block 1's shape; T odd (1001); Cin = 32 (one wgmma k-step a tap); Couts
# 72, 100 and 75 (a partial channel tile; no multiple of 8; odd); d = 16 with
# T below the reach; f32 out at block 3's shape (the f32 step's).
QTRAIN_EDGES = ((1, 3000, 128, 256, 1, torch.bfloat16), (2, 1001, 128, 256, 1, torch.bfloat16),
                (3, 300, 32, 72, 1, torch.bfloat16), (2, 301, 64, 100, 2, torch.float32),
                (3, 513, 128, 75, 4, torch.bfloat16), (2, 20, 64, 72, 16, torch.float32),
                (2, 750, 384, 512, 1, torch.float32))
# raw_store_slice: fit's steps with use_pallas_preprocess=False, and the
# batch the raw chain is held at on the card against the CPU.
RAW_STEPS = 10
RAW_CHAIN_ATOL = 1e-6
# Config #4: 3 s at 16 kHz, downsampling 1, over the bench store undecimated.
MEL_FRAG = 48000
# B6's edges (B, T, geometry): n_mels 32; T = 47999 and 30001, ending
# mid-frame and mid-tile; the librosa hop 160 / win 400 at n_fft 512; one
# frame; n_fft 256 and 1024 on the FFT route; on the DFT route n_fft 400
# (win 400 and hop 160; win 320 and hop 100; B = 1; B = 5 at T = 30001) and
# the odd n_fft 255 with win 200 (128 bins: a second pass of 6 n8 tiles).
MEL_EDGES = ((1, 48000, dict(n_mels=32)), (5, 47999, {}),
             (5, 48000, dict(hop_length=160, win_length=400)),
             (3, 47999, dict(hop_length=160, win_length=400, n_mels=32)),
             (2, 384, {}), (2, 30001, {}),
             (4, 48000, dict(n_fft=256, win_length=256, hop_length=128)),
             (2, 48000, dict(n_fft=1024, win_length=1024, hop_length=256)),
             (3, 48000, dict(n_fft=400, win_length=400, hop_length=160)),
             (3, 47999, dict(n_fft=400, win_length=400, hop_length=160, n_mels=32)),
             (3, 48000, dict(n_fft=400, win_length=320, hop_length=100)),
             (2, 48000, dict(n_fft=255, win_length=200)),
             (1, 48000, dict(n_fft=400, win_length=400, hop_length=160)),
             (5, 30001, dict(n_fft=400, win_length=400, hop_length=160)))
# B6's DFT route at B=2048 in the timing phase: the librosa geometry.
MEL_DFT = dict(n_fft=400, win_length=400, hop_length=160)
# Config #2: B9's (T, nq, ns, D) at the timing shape, in the n-shot form of
# 500 1-shot 5-way tasks, and at edges; the verification pairs; the train
# step's batch of pairs (2x the rows through the encoder).
B9_TIMING = (1, 4096, 4096, 64)
B9_NSHOT = (500, 1, 5, 64)
B9_EDGES = ((1, 33, 41, 64), (1, 1, 1, 64), (3, 7, 130, 17), (1, 5, 7, MAX_D),
            (4, 1, 3, MAX_D))
SIAMESE_PAIRS = 1000
# ASP (ops/cuda_asp) at the ECAPA cell's shape: a 2,048 batch of 3 s windows
# (298 frames) of MFA's 3,072 channels; and the rows of ECAPA's embed path.
ASP_SHAPE = (2048, 298, 3072)
ASP_TRAIN_ROWS = 512  # the ECAPA training cell's batch: ASP's backward is checked and timed there
ASP_BWD_RTOL = 2.0 ** -8  # a gradient row against float64: bf16 rounds each element to 2^-9
ASP_BWD_CHUNK = 32  # rows a float64 autograd chunk
ASP_SUM_GAMMAS = 6  # the softmax sum: each term's expf and up to n rescales, each expf and product
ECAPA_TRAIN_BATCH = 512  # the ECAPA training cell's batch
ASP_EMBED_ROWS = 16
ASP_EXTRA_DEPTH = 24  # the exponential's ulps, the products' and the merges' roundings
ASP_EMBED_MIN_COSINE = 0.9999
SIAMESE_BATCH = 64
# Config #4's train slice: batch 64 (its TrainConfig's), and the batches
# its step is timed at.
MEL_TRAIN_BATCH = 64
MEL_TRAIN_TIMING_BATCHES = (64, 2048)
# The corpus on disk that corpus_slice and streaming_embed read: FLAC in
# LibriSpeech's layout, one training and one validation subset of 20
# speakers × 5 utterances of 3.1-4.0 s each (the pure-Python FLAC encoder
# takes ~0.06 s of host time a second of audio: ~45 s for the 200 files).
CORPUS_SUBSETS = ("train-clean-100", "dev-clean")
CORPUS_SPEC = dict(n_speakers=20, utterances_per_speaker=5, min_seconds=3.1, max_seconds=4.0,
                   container="flac", seed=1234)
CORPUS_SIAMESE_STEPS = 10
# protocol_slice: the experiment CLIs in-process on a WAV corpus in
# LibriSpeech's layout: train-clean-100 of 20 speakers × 10 utterances for
# training, dev-clean and test-clean of 12 × 8 (3.1-4.0 s) for the frozen
# protocol (its 5-shot entries need 6 utterances a speaker, its 10-way entry
# 10 speakers). The soak checkpoint trains SOAK_STEPS[0] steps at batch
# TRAIN_BATCH, then resumes to SOAK_STEPS[1] (cut from the CLI's 2000),
# evaluating every SOAK_EVERY; config #2 trains SIAMESE_CLI_STEPS steps of
# SIAMESE_BATCH pairs. CLI_WIDTH: no options, the CLIs' own full widths
# (filters 128, embedding 64). The sweep runs k over SWEEP_K, past the 12
# speakers, so that its last points are skipped.
PROTOCOL_TRAIN_SPEC = dict(n_speakers=20, utterances_per_speaker=10, min_seconds=3.1,
                           max_seconds=4.0, container="wav", seed=1234)
PROTOCOL_EVAL_SPEC = dict(n_speakers=12, utterances_per_speaker=8, min_seconds=3.1,
                          max_seconds=4.0, container="wav", seed=4321)
SOAK_STEPS = (300, 400)
SOAK_EVERY = 100
SIAMESE_CLI_STEPS = 40
CLI_WIDTH: tuple = ()
SWEEP_K = (2, 14)
SWEEP_PAIRS = 1000

# pod_slice (config #5): a synthetic stand-in for LibriSpeech test-clean (40
# speakers, 2,620 utterances of ~7.4 s): 40 x 66 = 2,640 utterances of 3.5-11.5
# s (mean 7.5 s); synthetic_store gives every speaker the same count, so the
# counts are not the manifest's. ~0.97 GB of int16 on the host, ~0.24 GB
# decimated on the card. The scorer is timed at POD_SCORER_TASKS tasks of
# 1-shot 5-way. The process groups of pod_slice and dp_slice: NCCL (one rank
# a card, so world size 1 on the one card).
POD_STORE = dict(n_speakers=40, utterances_per_speaker=66, min_seconds=3.5, max_seconds=11.5)
POD_TASKS = 500
POD_SCORER_TASKS = (500, 20000)
PG_BACKEND = "nccl"
# dp_slice: the DP and single-device steps timed over this many steps a
# turn; fit(dp="on") at world size 1 for DP_FIT_STEPS steps.
DP_TIMING_STEPS = 20
DP_FIT_STEPS = 10
# mesh_slice: MESH_WORLD ranks, all on the one card, in one gloo group (NCCL
# refuses two ranks on one card) whose collectives parallel/comm stages
# through the host: the numbers are one card shared by the ranks over host
# transport, not collective costs across cards. Config #3's 12000 / 32 =
# 375 = 3·5³ samples after its pools, so seq 2 and 4 cannot shard it (nor
# config #1): seq 3.
MESH_WORLD = 6
MESH_DATA_SEQ = {"data": 2, "seq": 3}
MESH_DATA_MODEL = {"data": 3, "model": 2}
MESH_SP_BATCH = 16  # rows of the sequence-parallel embed
MESH_TP_ROWS = 64  # rows a data index of the tensor-parallel embed
MESH_MLP = (64, 512, 1024, 64)  # B, D, H, F of the tensor-parallel MLP
MESH_PP = (256, 32, 8)  # D, mb, n_micro of the homogeneous pipeline (S = MESH_WORLD)
MESH_PPR_EVAL = (32, 4)  # mb, n_micro of the real encoder's eval pipeline
MESH_PPR_TRAIN = (8, 3)  # mb, n_micro of its train step (f32)
# the data × seq step's store: 8 speakers × 4 utterances of 3.5-5 s
MESH_STORE = dict(n_speakers=8, utterances_per_speaker=4, min_seconds=3.5, max_seconds=5.0)
MESH_CALLS = 5  # timed calls of each program, after one warm-up
MESH_TIMEOUT = 600.0
# A picklable function each rank calls first (the CPU rehearsal sets one
# that counts the plain versions as launches); None on the card.
MESH_CHILD_SETUP = None
# the holds: the sharded forward against the dense f32 one, relative to the
# largest output; the data × seq step against the single-device full-batch
# step (loss; each gradient's and each new running statistic's cosine); the
# TP embedding against the f32 Dense on fast_embed's trunk and the TP MLP
# against the dense product; GPipe against the stages in turn; the real
# encoder's train pipeline against sequential autograd (loss, gradients and
# chained statistics relative to their largest value), its eval pipeline
# against fast_embed per microbatch
MESH_SP_RTOL = 1e-4
MESH_LOSS_RTOL = 1e-5
MESH_MIN_COSINE = 0.99999
MESH_TP_RTOL = 1e-5
MESH_PP_RTOL = 1e-5
MESH_PPR_GRAD_RTOL = 1e-4
MESH_PPR_STATS_RTOL = 1e-5
MESH_PPR_EVAL_RTOL = 1e-5

B1_RTOL, B1_ATOL = 1e-5, 1e-6
# B2's f32-GEMM kernel (CUDA cores) sums its taps in the plain version's
# order: bit for bit, held at this rtol.
B2_F32_RTOL, B2_F32_ATOL = 1e-5, 1e-5
# B2's tensor-core kernel against its plain version: both multiply the same
# bf16 values, exact in f32, and only the order of the f32 sums differs,
# which the tensor cores do not let one pin. Per output, f32 out:
#   |out − ref| <= u·(4·K·|mul|·(S + |bias|) + 4·(|ref| + |add|))
# (ops/block0_tc.order_bound: K = 32 taps, S = Σ|x·w| of the larger phase,
# u = 2^-24; the reasoning of B8's bound below). bf16 out: the same bound
# before the one rounding, so |out − ref| <= (1 + 2^-8)·bound + 2^-8·|ref|
# against the plain version's f32 value, and a row cosine; one bf16 ulp does
# not hold, because where the BatchNorm affine cancels to near zero a
# difference within the bound is many ulps of the result (up to 208 seen on
# an H100). int8 out: |q − q_ref| <= 1, and a differing entry only where
# the plain pooled value × inv_s0 lies within bound·|inv_s0| of a
# half-integer (block0_tc.requant_flips); the flips are counted.
B2_BF16_REL = 2.0 ** -8
B2_BF16_MIN_COSINE = 0.9999
TABLE_MIN_COSINE = 0.999
TRAIN_REL_TOL = 1e-4  # stats, dW, db: of max |value|, for the other sum order
# B4/B5 on the tensor cores (bf16 GEMM) against their plain versions: both
# multiply the same bf16 values, exact in f32; only the order of the f32
# sums differs. a_sel in f32 out: within block0_train_tc.sel_bound, B2's
# order bound with the affine taken away, u·(4·K·(S + |bias|) + 4·|ref|),
# K = 32; in bf16 out: that bound before its one rounding, (1 + 2^-8)·bound
# + 2^-8·|ref| against the plain f32 value (B2_BF16_REL), and a row cosine.
# #(a > 0): a channel's count may differ only by as many pre-activations as
# lie within their bound of 0 (block0_train_tc.relu_flips); B5's routing
# (read from its stage entry) only where two phases' s·a_j lie within their
# bounds of each other (route_flips); the flips are counted. Σa, Σa², dW
# and db to TRAIN_REL_TOL. B5's recomputed selection equal to B4's f32 a_sel
# bit for bit: both run the same products in the same order.
# The f32 route (3xTF32 on the tensor cores) against plain versions that
# round each product and sum in tap order: the same rules with the unit
# block0_train_tc.tf32x3_unit() (the split's error and three products' f32
# sums a tap) in place of 2^-24; dW and db to TRAIN_REL_TOL against the
# plain dW and db on B5's own routes and relu masks (its stage entry's),
# each flip held to the bound above, the gap to the plain routes reported.
B45_MIN_COSINE = 0.9999
STEP_LOSS_RTOL = 1e-3
STEP_MIN_COSINE = 0.999
STEP_ZERO_GRAD = 1e-6  # of the largest gradient's norm: zero but for rounding
INT8_FIDELITY_GATE = 0.999  # bench.py's gate
B6_ATOL = 1e-3  # log-mel, the JAX package's bound for its own kernel
MEL_INT8_MIN_COSINE = 0.99  # int8 against bf16, tests/test_quant_infer.py's bound for config #4
B9_MAX_ABS = 0.0  # B9 and its plain version sum in one pinned order: bit for bit
# B8 against its plain version, f32 output. Both multiply the same bf16
# values, so every product is exact in f32 and only the order of the f32 sums
# differs: each order lies within (K − 1)·u·S of the exact sum (u = 2^-24,
# S = Σ|x·w| over the K = k·Cin products), and the tensor cores' additions
# need not round to nearest (up to 2u each). So per output:
#   |out − ref| <= u·(B8_TERM_ULPS·K·|mul|·(S + |bias|) + B8_EPILOGUE_ULPS·(|ref| + |add|))
# the second term for the epilogue's own roundings. bf16 output: each side
# rounds once, so they differ by at most about one bf16 ulp an element
# (1 − cosine ≤ 2^-17); held by row cosine.
F32_UNIT_ROUNDOFF = 2.0 ** -24
BN_EPS = 1e-3  # the configs' BatchNorm epsilon (flax's)
B8_TERM_ULPS = 4
B8_EPILOGUE_ULPS = 4
B8_BF16_MIN_COSINE = 0.9999

# The f32 peak counts an FMA as 2 operations: the lanes issue half as many
# instructions (132 SMs x 128 lanes at ~1.98 GHz).
F32_INSTR_PER_S = F32_OPS_PER_S / 2

# name -> (wrapper, its launch counter, source, TPU kernel it replaces). B2,
# B4, B5 and B6 have two kernels each, chosen by their arguments: B2's, B4's
# and B5's tensor-core kernels count on ``launches`` (every bf16 GEMM), their
# f32-GEMM kernels on ``f32_launches``; B6's ``launches`` counts both of its
# routes and ``dft_launches`` the DFT route alone.
KERNELS = {
    "gather_whiten": (gather_whiten, "launches", "voicemap_tpu_torch/csrc/gather_whiten.cu",
                      "voicemap_tpu/ops/pallas_preprocess.py:88"),
    "conv_block0": (conv_block0, "launches", "voicemap_tpu_torch/csrc/conv_block0.cu",
                    "voicemap_tpu/ops/pallas_conv.py:97"),
    "conv_block0_f32": (conv_block0, "f32_launches", "voicemap_tpu_torch/csrc/conv_block0.cu",
                        "voicemap_tpu/ops/pallas_conv.py:97"),
    "quant_block": (quant_block, "launches", "voicemap_tpu_torch/csrc/quant_block.cu",
                    "voicemap_tpu/ops/pallas_quant_block.py:99"),
    "conv_block0_train": (conv_block0_train, "launches",
                          "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                          "voicemap_tpu/ops/pallas_conv_train.py:58"),
    "conv_block0_train_bwd": (conv_block0_train_bwd, "launches",
                              "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                              "voicemap_tpu/ops/pallas_conv_train.py:125"),
    "conv_block0_train_f32": (conv_block0_train, "f32_launches",
                              "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                              "voicemap_tpu/ops/pallas_conv_train.py:58"),
    "conv_block0_train_bwd_f32": (conv_block0_train_bwd, "f32_launches",
                                  "voicemap_tpu_torch/csrc/conv_block0_train.cu",
                                  "voicemap_tpu/ops/pallas_conv_train.py:125"),
    "pool_fwd": (pool_fwd, "launches", "voicemap_tpu_torch/csrc/routing.cu",
                 "voicemap_tpu/ops/pallas_routing.py:69"),
    "route_bwd": (route_bwd, "launches", "voicemap_tpu_torch/csrc/routing.cu",
                  "voicemap_tpu/ops/pallas_routing.py:133"),
    "log_mel": (log_mel, "launches", "voicemap_tpu_torch/csrc/log_mel.cu",
                "voicemap_tpu/ops/pallas_melspec.py:52"),
    "log_mel_dft": (log_mel, "dft_launches", "voicemap_tpu_torch/csrc/log_mel.cu",
                    "voicemap_tpu/ops/pallas_melspec.py:52"),
    "weighted_l1": (weighted_l1, "launches", "voicemap_tpu_torch/csrc/weighted_l1.cu",
                    "voicemap_tpu/ops/pallas_distance.py:33"),
    "conv_blockn": (conv_blockn, "launches", "voicemap_tpu_torch/csrc/conv_blockn.cu",
                    "voicemap_tpu/ops/pallas_conv.py:300"),
    "quant_block_stage": (quant_block_stage, "launches", "voicemap_tpu_torch/csrc/quant_block.cu",
                          "benchmarks/bench_qblock_attrib.py:43"),
    "quant_block_train": (quant_block_train, "launches", "voicemap_tpu_torch/csrc/quant_block.cu",
                          "voicemap_tpu/ops/pallas_quant_block.py:99"),
    "pool_fwd_idx": (pool_fwd, "idx_launches", "voicemap_tpu_torch/csrc/routing.cu",
                     "voicemap_tpu/ops/pallas_routing.py:69"),
    "route_bwd_idx": (route_bwd, "idx_launches", "voicemap_tpu_torch/csrc/routing.cu",
                      "voicemap_tpu/ops/pallas_routing.py:133"),
    # The BatchNorm epilogue pair: on the TPU, XLA's pool-rate chain (the
    # affine after the custom VJP's forward; â and the two sums in its backward)
    "bn_apply": (bn_apply, "launches", "voicemap_tpu_torch/csrc/routing.cu",
                 "voicemap_tpu/ops/conv_train.py:295 (XLA's pool-rate chain)"),
    "bn_grad": (bn_grad, "launches", "voicemap_tpu_torch/csrc/routing.cu",
                "voicemap_tpu/ops/conv_train.py:323 (XLA's pool-rate chain)"),
    # ECAPA-TDNN's attentive statistics pooling: weighted, and the global context
    "asp_stats": (asp_stats, "launches", "voicemap_tpu_torch/csrc/asp_stats.cu",
                  "none: the port's own configuration"),
    "asp_global": (asp_stats, "global_launches", "voicemap_tpu_torch/csrc/asp_stats.cu",
                   "none: the port's own configuration"),
    # ASP's backward, both modes on one counter (ECAPA-TDNN's training)
    "asp_bwd": (asp_stats, "backward_launches", "voicemap_tpu_torch/csrc/asp_stats.cu",
                "none: the port's own configuration"),
    # The dilated convs' weight gradient in training (config #3's blocks 1,
    # 3, 5, 7), which the JAX package leaves to XLA
    "conv_wgrad": (conv_wgrad, "launches", "voicemap_tpu_torch/csrc/conv_wgrad.cu",
                   "none: XLA's conv transpose (voicemap_tpu/ops/conv_train.py:367)"),
}
# The train kernels' plain versions, by the module attribute each wrapper
# is reached through on the train path (B7's serve both of its modes; B3's
# train epilogue and B8 with its rows are the int8 and the
# pool-rate-residual forwards' convs; the BatchNorm epilogue pair runs after
# every fused block; conv_wgrad is the dilated blocks' weight gradient).
PLAIN = ((cuda_conv_train, "conv_block0_train", conv_block0_train_reference),
         (cuda_conv_train, "conv_block0_train_bwd", conv_block0_train_bwd_reference),
         (cuda_routing, "pool_fwd", pool_fwd_reference),
         (cuda_routing, "route_bwd", route_bwd_reference),
         (cuda_quant_block, "quant_block_train", quant_block_train_reference),
         (cuda_conv, "conv_blockn_rows", conv_blockn_rows_reference),
         (cuda_routing, "bn_apply", bn_apply_reference),
         (cuda_routing, "bn_grad", bn_grad_reference),
         (cuda_wgrad, "conv_wgrad", conv_wgrad_reference))
# The eager chain the BatchNorm epilogue pair replaced, by its ops on a
# block's pool-rate output: the affine and the gradient's â (with a
# per-channel vector), the cast, the dropout's divide and where, and their
# gradients (any of these three).
CHAIN_WITH_VECTOR = ("aten::sub", "aten::mul", "aten::add")
CHAIN_ANY = ("aten::div", "aten::where", "aten::_to_copy")


STARTED: list = []  # main's start on the host clock


def emit(record: dict) -> None:
    """One JSON line; a phase's record also gets the seconds since the run
    began and the device memory then allocated and reserved."""
    if "phase" in record and STARTED:
        record = {**record, "at_s": time.perf_counter() - STARTED[0],
                  "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                  "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    print(json.dumps(record), flush=True)


def warm_workspaces() -> None:
    """The libraries' long-lived workspaces (cuBLAS in f32, f64 and bf16,
    cuBLASLt's int8 GEMM) allocated while the card is empty: one allocated
    later inside a large freed segment keeps the whole segment reserved,
    and config #3's jnp step at B=2048 peaks within 2 GB of the card's
    memory (dilated_timing's peak_mem_gb)."""
    if torch.device(DEVICE).type != "cuda":
        return
    a = torch.ones(64, 64, device=DEVICE)
    for t in (a, a.double(), a.to(torch.bfloat16)):
        t @ t
    q = torch.ones(64, 64, dtype=torch.int8, device=DEVICE)
    torch._int_mm(q, q)
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def reset_counts() -> None:
    for wrapper, counter, _, _ in KERNELS.values():
        setattr(wrapper, counter, 0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: getattr(wrapper, counter)
            for name, (wrapper, counter, _, _) in KERNELS.items()}


def bound(bytes_moved: float, ops: float, ops_per_s: float, *more: tuple) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type, summed
    over the kinds of operation (``more``: further ``(ops, ops_per_s)``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s + sum(o / r for o, r in more)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def random_flax_variables(cfg: EncoderConfig, num_classes: int, seed: int,
                          mel: bool = False) -> dict:
    """A classifier's flax variable tree in ``ConvEncoder`` shapes, or with
    ``mel`` in ``MelSpecEncoder`` shapes (3×3 HWIO kernels, widths
    ``max(filters // 4, 8)`` times the multipliers), as numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def uniform(lo, hi, n):
        return rng.uniform(lo, hi, n).astype(np.float32)

    params, stats = {}, {}
    cin = 1
    for i, (mult, k) in enumerate(zip(cfg.filter_multipliers, cfg.kernel_sizes)):
        c = max(cfg.filters // 4, 8) * mult if mel else cfg.filters * mult
        shape = (3, 3, cin, c) if mel else (k, cin, c)
        params[f"block_{i}"] = {
            "conv": {"kernel": normal(shape, (np.prod(shape[:-1])) ** -0.5),
                     "bias": normal((c,), 0.05)},
            "bn": {"scale": uniform(0.5, 1.5, c), "bias": normal((c,), 0.1)},
        }
        stats[f"block_{i}"] = {"bn": {"mean": normal((c,), 0.1),
                                      "var": uniform(0.5, 2.0, c)}}
        cin = c
    d = cfg.embedding_dim
    params["embed"] = {"kernel": normal((cin, d), cin ** -0.5), "bias": normal((d,), 0.01)}
    head = {"kernel": normal((d, num_classes), d ** -0.5), "bias": np.zeros(num_classes, np.float32)}
    return {"params": {"encoder": params, "head": head},
            "batch_stats": {"encoder": stats}}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def min_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1).min())


def bench_store(seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decimated bench store, row ids, and decimated offsets with the
    edges: 0, the last valid start, and starts that run past the row."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-20000, 20000, size=(BATCH, STORE_T), dtype=np.int16)
    store = decimate_store(torch.from_numpy(raw).to(DEVICE), DS)
    last = store.shape[1] - FRAG
    offsets = rng.integers(0, last + 1, BATCH).astype(np.int32)
    offsets[:5] = [0, last, last + 1, store.shape[1] - 100, store.shape[1]]
    idx = rng.permutation(BATCH).astype(np.int32)
    return store, torch.from_numpy(idx).to(DEVICE), torch.from_numpy(offsets).to(DEVICE)


def block0_params(seed: int, c: int = 128) -> tuple:
    """Block-0 parameters; half the BatchNorm scales negative, so the order of
    affine and max matters."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(32, 1, c, generator=g) * (32 ** -0.5)
    b = torch.randn(c, generator=g) * 0.05
    scale = torch.rand(c, generator=g) + 0.5
    scale[::2] *= -1.0
    bias, mean = torch.randn(c, generator=g) * 0.1, torch.randn(c, generator=g) * 0.1
    var = torch.rand(c, generator=g) * 1.5 + 0.5
    return tuple(t.to(DEVICE) for t in (w, b, scale, bias, mean, var))


def requant_scale_for(x: torch.Tensor, params: tuple) -> torch.Tensor:
    """Per-channel s0 = max-abs / 127 of the block's own f32 output, as
    calibration makes it."""
    pooled = conv_block0_reference(x, *params, out_dtype=torch.float32)
    return pooled.abs().amax(dim=(0, 1)).clamp(min=1e-8) / 127.0


def qblock_inputs(seed: int, B: int, T: int, cin: int, cout: int) -> tuple:
    """B3's inputs on the card, as ``utils/qblock_attrib`` draws them."""
    return qblock_attrib.block_inputs(seed, B, T, cin, cout, DEVICE)


def blockn_inputs(seed: int, B: int, T: int, cin: int, cout: int, k: int = 3) -> tuple:
    """bf16 activations and a block's parameters on the card: w at the
    fan-in scale, half the BatchNorm scales negative (the max after the
    affine then differs from the max before it)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(B, T, cin, generator=g, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(k, cin, cout, generator=g, device=DEVICE) * (k * cin) ** -0.5
    b = torch.randn(cout, generator=g, device=DEVICE) * 0.05
    scale = torch.rand(cout, generator=g, device=DEVICE) + 0.5
    scale[::2] *= -1.0
    bias, mean = (torch.randn(cout, generator=g, device=DEVICE) * 0.1 for _ in range(2))
    var = torch.rand(cout, generator=g, device=DEVICE) * 1.5 + 0.5
    return x, (w, b, scale, bias, mean, var)


def block_params(blk) -> tuple:
    """A ConvBlock's parameters as B8 takes them: the flax-layout kernel, the
    conv bias, BatchNorm's scale, bias, running mean and variance."""
    return (blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.bn.running_mean, blk.bn.running_var)


def blockn_bound(x: torch.Tensor, params: tuple, ref: torch.Tensor, pool: int = 2,
                 dilation: int = 1) -> torch.Tensor:
    """The per-output bound on B8 against its plain version (f32 output); K
    = k·Cin products at any dilation."""
    w = params[0]
    k, cin, cout = w.shape
    zeros, ones = torch.zeros(cout, device=x.device), torch.ones(cout, device=x.device)
    s = conv_blockn_reference(x.abs(), w.abs(), zeros, ones, zeros, zeros, ones, 0.0, pool,
                              out_dtype=torch.float32,
                              dilation=dilation)  # Σ|x·w|, the larger of the pool's
    bias, mul, add = bn_affine(*params[1:], BN_EPS)
    return F32_UNIT_ROUNDOFF * (B8_TERM_ULPS * k * cin * mul.abs() * (s + bias.abs())
                                + B8_EPILOGUE_ULPS * (ref.abs() + add.abs()))


def check_blockn(x: torch.Tensor, params: tuple, pool: int = 2, dilation: int = 1) -> dict:
    """B8 against its plain version: f32 output within ``blockn_bound``,
    bf16 output by row cosine."""
    B, T, cin = x.shape
    k, _, cout = params[0].shape
    shape = (B, T // pool, cout)
    kw = dict(dilation=dilation)
    out = conv_blockn(x, *params, BN_EPS, pool, out_dtype=torch.float32, **kw)
    ref = conv_blockn_reference(x, *params, BN_EPS, pool, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    name = (B, T, cin, cout, k, pool, dilation)
    if tuple(out.shape) != shape or tuple(ref.shape) != shape:
        raise AssertionError(f"conv_blockn {name}: {tuple(out.shape)}, want {shape}")
    diff = (out - ref).abs()
    ratio, err = 0.0, 0.0
    if diff.numel():
        bnd = blockn_bound(x, params, ref, pool, dilation)
        ratio = float((diff / bnd.clamp(min=1e-30)).max())
        err = float(diff.max())
        del bnd
    if not ratio <= 1.0:
        raise AssertionError(f"conv_blockn {name} f32: max abs err {err}, {ratio} of its bound")
    del out, ref, diff
    outb = conv_blockn(x, *params, BN_EPS, pool, **kw)
    refb = conv_blockn_reference(x, *params, BN_EPS, pool, **kw)
    torch.cuda.synchronize()
    cos, ulps = 1.0, 0
    if outb.numel():
        cos = min_cosine(outb.reshape(B, -1).float(), refb.reshape(B, -1).float())
        ulps = bf16_ulps(outb, refb)
    if not cos >= B8_BF16_MIN_COSINE:
        raise AssertionError(f"conv_blockn {name} bf16: row cosine {cos}")
    extra = {} if (pool, dilation) == (2, 1) else {"pool": pool, "dilation": dilation}
    return {"kernel": "conv_blockn", "shape": [B, T, cin, cout, k], "out": list(shape), **extra,
            "max_abs_err": err, "err_over_bound": ratio,
            "bf16_min_row_cosine": cos, "bf16_max_ulps": ulps,
            "tolerance": f"f32: |err| <= u*({B8_TERM_ULPS}*K*|mul|*(S+|bias|) + "
                         f"{B8_EPILOGUE_ULPS}*(|ref|+|add|)), u = 2^-24, S = sum|x*w|; "
                         f"bf16: row cosine >= {B8_BF16_MIN_COSINE}"}


def scaled_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its batch rows scaled by ROW_SCALES in turn."""
    scale = torch.tensor(ROW_SCALES, device=x.device)[torch.arange(x.shape[0]) % len(ROW_SCALES)]
    return (x.float() * scale[:, None, None]).to(x.dtype)


def check_blockn_kernels() -> tuple[list, float]:
    """B8 at config #1's three block shapes (CHECK_ROWS rows), at B = 1 at
    each of them, at B8_EDGES and with rows of ROW_SCALES; the largest f32
    error at the main shapes."""
    checks = []
    for i, (T, cin, cout, _) in enumerate(QBLOCKS):
        x, params = blockn_inputs(100 + i, CHECK_ROWS, T, cin, cout)
        checks.append(check_blockn(x, params))
        del x, params
    err = max(c["max_abs_err"] for c in checks)
    for i, (T, cin, cout, _) in enumerate(QBLOCKS):
        checks.append(check_blockn(*blockn_inputs(200 + i, 1, T, cin, cout)))
    for B, T, cin, cout, k in B8_EDGES:
        checks.append(check_blockn(*blockn_inputs(B + T + cin, B, T, cin, cout, k)))
    x, params = blockn_inputs(7, len(ROW_SCALES), 300, 128, 256)
    checks.append({**check_blockn(scaled_rows(x), params), "row_scales": list(ROW_SCALES)})
    return checks, err


def check_qblock(args: tuple, pool: int = 2, dilation: int = 1, out_dtype=None) -> dict:
    """B3 against its plain version, equal: int8 out, or the last block's
    ``out_dtype``."""
    kw = dict(pool=pool, dilation=dilation)
    if out_dtype is not None:
        kw.update(last=True, out_dtype=out_dtype)
    B, T = args[0].shape[:2]
    shape = (B, T // pool, args[1].shape[2])
    return {**check_exact("quant_block", quant_block(*args, **kw),
                          quant_block_reference(*args, **kw), shape),
            "pool": pool, "dilation": dilation}


def check_dilated_kernels() -> tuple[list, dict]:
    """B3 (bit for bit) and B8 (f32 out within ``blockn_bound``, bf16 out by
    row cosine) at config #3's seven block shapes (CHECK_ROWS rows), at B = 1
    at each of them, at DILATED_EDGES and on rows of very different scale;
    the largest errors at the seven shapes."""
    checks = []
    for i, (T, cin, cout, pool, d, last) in enumerate(DILATED_BLOCKS):
        args = qblock_inputs(300 + i, CHECK_ROWS, T, cin, cout)
        checks.append(check_qblock(args, pool, d, torch.bfloat16 if last else None))
        del args
        x, params = blockn_inputs(300 + i, CHECK_ROWS, T, cin, cout)
        checks.append(check_blockn(x, params, pool, d))
        del x, params
        torch.cuda.empty_cache()
    errors = {k: max(c["max_abs_err"] for c in checks if c["kernel"] == k)
              for k in ("quant_block", "conv_blockn")}
    cases = [(1, T, cin, cout, pool, d, torch.bfloat16 if last else None)
             for T, cin, cout, pool, d, last in DILATED_BLOCKS] + list(DILATED_EDGES)
    for B, T, cin, cout, pool, d, dt in cases:
        checks.append(check_qblock(qblock_inputs(B + T + d, B, T, cin, cout), pool, d, dt))
        checks.append(check_blockn(*blockn_inputs(B + T + d, B, T, cin, cout), pool, d))
    # rows of very different scale: a read across the batch-row boundary,
    # 2h = 16 rows deep here, shows
    x, *rest = qblock_inputs(19, 3, 300, 128, 128)
    x[1] = torch.div(x[1], 64, rounding_mode="trunc")
    x[2] = torch.div(x[2], 8, rounding_mode="trunc")
    checks.append({**check_qblock((x, *rest), 1, 8), "row_divisors": [1, 64, 8]})
    x, params = blockn_inputs(19, len(ROW_SCALES), 300, 128, 128)
    checks.append({**check_blockn(scaled_rows(x), params, 1, 8), "row_scales": list(ROW_SCALES)})
    return checks, errors


def check_qblock_stages() -> list:
    """B10 at the three block shapes: mma and pool equal to their plain
    versions, full equal to B3's mid block."""
    checks = []
    for i, (T, cin, cout, _) in enumerate(QBLOCKS):
        args = qblock_inputs(i, CHECK_ROWS, T, cin, cout)
        for stage in STAGES:
            want = (quant_block(*args) if stage == "full"
                    else quant_block_stage_reference(*args, stage))
            c = check_exact("quant_block_stage", quant_block_stage(*args, stage), want,
                            (CHECK_ROWS, T // 2, cout))
            checks.append({**c, "stage": stage})
        del args
    return checks


def check_block0(x: torch.Tensor, params: tuple) -> list:
    """B2's tensor-core kernel against its plain version at f32, bf16 and
    int8 output, each to its stated tolerance (B2_BF16_REL above)."""
    B, T = x.shape[:2]
    c = params[1].shape[0]
    shape = (B, T // 4, c)
    ref = conv_block0_reference(x, *params, BN_EPS, out_dtype=torch.float32)
    bias, mul, add = bn_affine(*params[1:], BN_EPS)
    bnd = block0_tc.order_bound(x, params[0], bias, mul, add, ref)
    out = conv_block0(x, *params, BN_EPS, out_dtype=torch.float32)
    outb = conv_block0(x, *params, BN_EPS)
    refb = conv_block0_reference(x, *params, BN_EPS)
    s0 = ref.abs().amax(dim=(0, 1)).clamp(min=1e-8) / 127.0
    q = conv_block0(x, *params, BN_EPS, requant_scale=s0)
    q_ref = conv_block0_reference(x, *params, BN_EPS, requant_scale=s0)
    torch.cuda.synchronize()
    for got, dt in ((out, torch.float32), (outb, torch.bfloat16), (q, torch.int8)):
        if tuple(got.shape) != shape or got.dtype != dt:
            raise AssertionError(f"conv_block0 {(B, T, c)}: {tuple(got.shape)} {got.dtype}, "
                                 f"want {shape} {dt}")
    tiny = torch.full((), 1e-30, dtype=torch.float64, device=x.device)
    diff = (out - ref).abs()
    ratio = float((diff / torch.maximum(bnd, tiny)).max()) if diff.numel() else 0.0
    if not ratio <= 1.0:
        raise AssertionError(f"conv_block0 {(B, T, c)} f32: {ratio} of its order bound")
    tolb = (1 + B2_BF16_REL) * bnd + B2_BF16_REL * ref.abs().double()
    ratio_b = float(((outb.float() - ref).abs() / torch.maximum(tolb, tiny)).max())
    cos = min_cosine(outb.reshape(B, -1).float(), refb.reshape(B, -1).float())
    if not (ratio_b <= 1.0 and cos >= B2_BF16_MIN_COSINE):
        raise AssertionError(f"conv_block0 {(B, T, c)} bf16: {ratio_b} of its bound, "
                             f"row cosine {cos}")
    flips = block0_tc.requant_flips(q, q_ref, ref, 1.0 / s0.float(), bnd)
    base = {"kernel": "conv_block0", "route": "tensor cores", "shape": list(shape)}
    return [{**base, "dtype": "float32", "max_abs_err": float(diff.max()),
             "err_over_bound": ratio,
             "tolerance": "|err| <= u*(4*K*|mul|*(S+|bias|) + 4*(|ref|+|add|)), u = 2^-24, "
                          "K = 32, S = sum|x*w|"},
            {**base, "dtype": "bfloat16",
             "max_abs_err": float((outb.float() - refb.float()).abs().max()),
             "err_over_bound": ratio_b, "min_row_cosine": cos,
             "max_ulps_vs_plain_bf16": bf16_ulps(outb, refb),
             "tolerance": f"|out - ref_f32| <= (1 + 2^-8)*bound + 2^-8*|ref_f32|; row cosine "
                          f">= {B2_BF16_MIN_COSINE}"},
            {**base, "dtype": "int8",
             "max_abs_err": float((q.float() - q_ref.float()).abs().max()), "flips": flips,
             "tolerance": "|q - q_ref| <= 1, only where ref*inv_s0 is within "
                          "bound*|inv_s0| of a half-integer"}]


def check_block0_f32(x: torch.Tensor, params: tuple) -> dict:
    """B2's f32-GEMM kernel (CUDA cores) against its plain version: the same
    tap order, held at B2_F32_RTOL."""
    out = conv_block0(x, *params, BN_EPS, out_dtype=torch.float32, gemm_dtype=torch.float32)
    ref = conv_block0_reference(x, *params, BN_EPS, out_dtype=torch.float32,
                                gemm_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=B2_F32_RTOL, atol=B2_F32_ATOL)
    return {"kernel": "conv_block0", "route": "float32 GEMM", "dtype": "float32",
            "shape": list(out.shape), "max_abs_err": float((out - ref).abs().max()),
            "tolerance": f"rtol {B2_F32_RTOL}, atol {B2_F32_ATOL}"}


def check_exact(name: str, out: torch.Tensor, ref: torch.Tensor, shape: tuple) -> dict:
    """``out`` equal to ``ref``: int8 by value, bf16 to 0 ulps."""
    torch.cuda.synchronize()
    if tuple(out.shape) != shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype}, want {shape} {ref.dtype}")
    if out.dtype == torch.bfloat16:
        ulps = bf16_ulps(out, ref) if out.numel() else 0
        ok, tol = ulps == 0, f"0 bf16 ulps (max {ulps})"
    else:
        ok, tol = bool(torch.equal(out, ref)), "equal"
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    if not ok:
        raise AssertionError(f"{name} {shape} {out.dtype}: not {tol}, max abs err {err}")
    return {"kernel": name, "dtype": str(out.dtype).split(".")[-1], "shape": list(shape),
            "max_abs_err": err, "tolerance": tol}


def check_edges() -> list:
    """Shapes off the main path: for B2 T % 4 != 0 and C = 16 and 160 (the
    tensor-core kernel in f32, bf16 and int8 out, and the f32-GEMM kernel),
    rows of very different scale, and more rows than a grid's y dimension
    holds (the persistent grid); a negative offset and indices outside the store for B1 (NaN rows,
    no stray read); for B3 odd T, B = 3, Couts that are no multiple of the
    kernel's 128-channel tile (40, 72, 100, 75: no multiple of 8, 75 odd; int8,
    bf16 and f32 out), Cin = 480 and 512 (past the first design's cap), a
    one-step output, B = 1 at config #1's three block shapes, and rows of very
    different scale."""
    checks = []
    g = torch.Generator().manual_seed(1)
    for B, T, c in B2_EDGES:
        x = (torch.randn(B, T, 1, generator=g) * 0.05).to(DEVICE)
        params = block0_params(B + T, c)
        checks.extend(check_block0(x, params))
        checks.append(check_block0_f32(x, params))
    x = (torch.randn(len(ROW_SCALES), FRAG, 1, generator=g) * 0.3).to(DEVICE)
    checks.extend({**c, "row_scales": list(ROW_SCALES)}
                  for c in check_block0(scaled_rows(x), block0_params(5)))
    B, T, c = B2_WIDE
    x = (torch.randn(B, T, 1, generator=g) * 0.3).to(DEVICE)
    checks.extend(check_block0(x, block0_params(6, c)))
    store = torch.randint(-20000, 20000, (4, 1500), generator=g, dtype=torch.int16).to(DEVICE)
    idx = torch.tensor([2, 0, -1, 4], dtype=torch.int32, device=DEVICE)
    offsets = torch.tensor([-7, 600, 0, 0], dtype=torch.int32, device=DEVICE)
    got = gather_whiten(store, idx, offsets, 1000)
    want = gather_whiten_reference(store, idx[:2], offsets[:2], 1000)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:2], want, rtol=B1_RTOL, atol=B1_ATOL)
    if not bool(got[2:].isnan().all()):
        raise AssertionError("gather_whiten: rows of indices outside the store are not NaN")
    checks.append({"kernel": "gather_whiten", "shape": list(got.shape),
                   "max_abs_err": float((got[:2] - want).abs().max()),
                   "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}; NaN rows for indices -1, N"})
    edges = ((3, 1001, 96, 40, False, None), (3, 1001, 96, 40, True, torch.bfloat16),
             (3, 1001, 96, 40, True, torch.float32), (1, 3, 32, 8, False, None),
             (2, 130, 480, 72, True, torch.bfloat16), (2, 130, 512, 72, False, None),
             (2, 301, 64, 100, False, None), (3, 513, 128, 75, True, torch.bfloat16))
    edges += tuple((1, T, cin, cout, last, torch.bfloat16 if last else None)
                   for T, cin, cout, last in QBLOCKS)
    for B, T, cin, cout, last, dt in edges:
        args = qblock_inputs(T + cin, B, T, cin, cout)
        kw = {"last": last, "out_dtype": dt} if last else {}
        checks.append(check_exact("quant_block", quant_block(*args, **kw),
                                  quant_block_reference(*args, **kw), (B, T // 2, cout)))
    # rows of very different scale: a read across the batch-row boundary shows
    x, *rest = qblock_inputs(9, 3, 300, 128, 256)
    x[1] = torch.div(x[1], 64, rounding_mode="trunc")
    x[2] = torch.div(x[2], 8, rounding_mode="trunc")
    checks.append({**check_exact("quant_block", quant_block(x, *rest),
                                 quant_block_reference(x, *rest), (3, 150, 256)),
                   "row_divisors": [1, 64, 8]})
    return checks


def check_kernels(store, idx, offsets, params) -> dict:
    """Every config #1 kernel against its plain version, the launch
    counters read around the phase (B2's f32-GEMM kernel runs only here)."""
    reset_counts()
    got = gather_whiten(store, idx, offsets, FRAG)
    want = gather_whiten_reference(store, idx, offsets, FRAG)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=B1_RTOL, atol=B1_ATOL)
    errors = {"gather_whiten": float((got - want).abs().max())}
    checks = [{"kernel": "gather_whiten", "shape": list(got.shape),
               "max_abs_err": errors["gather_whiten"],
               "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}"}]

    x = got[:CHECK_ROWS, :, None]
    b2 = check_block0(x, params)
    b2.append(check_block0_f32(x, params))
    b2.extend(check_block0(x[:1], params))  # B = 1: the tiles narrow to reach the SMs
    errors["conv_block0"] = max(c["max_abs_err"] for c in b2 if c["dtype"] == "bfloat16")
    errors["conv_block0_int8"] = max(c["max_abs_err"] for c in b2 if c["dtype"] == "int8")
    errors["conv_block0_f32"] = b2[3]["max_abs_err"]
    checks.extend(b2)
    s0 = requant_scale_for(x, params)
    del x, got, want

    errors["quant_block"] = 0.0
    for i, (T, cin, cout, last) in enumerate(QBLOCKS):
        args = qblock_inputs(i, CHECK_ROWS, T, cin, cout)
        c = check_exact("quant_block", quant_block(*args, last=last),
                        quant_block_reference(*args, last=last), (CHECK_ROWS, T // 2, cout))
        errors["quant_block"] = max(errors["quant_block"], c["max_abs_err"])
        checks.append(c)
        del args
    checks.extend(check_edges())
    blockn_checks, errors["conv_blockn"] = check_blockn_kernels()
    checks.extend(blockn_checks)
    checks.extend(check_qblock_stages())
    errors["quant_block_stage"] = max(c["max_abs_err"] for c in checks
                                      if c["kernel"] == "quant_block_stage")
    dilated, dilated_errors = check_dilated_kernels()
    for k, v in dilated_errors.items():
        errors[k] = max(errors[k], v)
    launches = read_counts()
    emit({"phase": "kernels", "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                                       "matmul": torch.backends.cuda.matmul.allow_tf32},
          "checks": checks, "dilated_checks": dilated, "launches": launches})
    return {"errors": errors, "s0": s0, "launches": launches}


def run_slice(seed: int, cfg=None, phase: str = "slice", host=None) -> dict:
    """``cfg`` (config #1 by default) at full width from a flax-layout tree,
    the 500 tasks over the seeded store in bf16 through ``fast_embed``, the
    launch counters read around the run, the table held against the
    plain-version path (B1's plain version, then the module's forward)."""
    cfg = cfg or classifier_baseline()
    host = host or synthetic_store(seed, **SLICE_STORE)
    n_speakers = host.speaker_counts.shape[0]
    model = SpeakerClassifier(cfg.encoder, n_speakers, device=DEVICE)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n_speakers, seed),
                                    cfg.encoder))
    store = device_store_for(cfg, host, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    reset_counts()
    t0 = time.perf_counter()
    table = nshot.embed_all(model, store, cfg, fast=True)
    acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, fast=True,
                         table=table)
    launches = read_counts()
    seconds = time.perf_counter() - t0

    n_utts = host.audio.shape[0]
    if table.shape != (n_utts, cfg.encoder.embedding_dim) or table.dtype != torch.float32:
        raise AssertionError(f"embedding table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("embedding table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc} outside [0, 1]")
    missing = [name for name in ("gather_whiten", "conv_block0") if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")
    want_b8 = blockn_launches(model.encoder, n_utts)
    if launches["conv_blockn"] != want_b8:
        raise AssertionError(f"conv_blockn launched {launches['conv_blockn']} times, want "
                             f"{want_b8} (the blocks B8 takes x the embed chunks)")

    # The plain-version path: reference gather + the module forward (cuDNN
    # for every block), from the same offset-0 fragments.
    plain = []
    with torch.inference_mode():
        for x in plain_fragments(store, cfg, n_utts):
            plain.append(model.embed(x))
    min_cos = min_cosine(table, torch.cat(plain))
    if min_cos < TABLE_MIN_COSINE:
        raise AssertionError(f"table vs plain path: min cosine {min_cos} < {TABLE_MIN_COSINE}")
    emit({"phase": phase, "config": cfg.name, "dtype": "bfloat16",
          "utterances": n_utts, "speakers": n_speakers, "tasks": 500, "n_shot": 1, "k_way": 5,
          "accuracy": acc, "table_shape": list(table.shape), "launches": launches,
          "min_cosine_vs_plain": min_cos, "cosine_tolerance": TABLE_MIN_COSINE,
          "seconds": seconds})
    return {"launches": launches, "model": model, "cfg": cfg, "store": store,
            "table": table, "accuracy": acc, "host": host}


def blockn_launches(encoder, n_utts: int) -> int:
    """B8's launches for one ``embed_all`` of ``n_utts`` rows: the blocks it
    takes times the chunks of 256 rows."""
    return sum(takes_blockn(b) for b in encoder.blocks[1:]) * -(-n_utts // 256)


def plain_fragments(store: DeviceStore, cfg, n_utts: int):
    """The offset-0 fragments of every utterance, through B1's plain version."""
    d = cfg.data
    for start in range(0, n_utts, CHECK_ROWS):
        idx = torch.arange(start, min(start + CHECK_ROWS, n_utts), device=DEVICE,
                           dtype=torch.int32)
        yield gather_whiten_reference(store.audio, idx, torch.zeros_like(idx),
                                      d.model_length, d.whiten_rms, d.whiten_eps)[..., None]


def quant_embed_plain(encoder, qvars: dict, x: torch.Tensor) -> torch.Tensor:
    """``quant_embed`` with every kernel replaced by its plain version."""
    cdt = encoder.compute_dtype
    blk = encoder.blocks[0]
    pools, dilations = encoder.cfg.pool_sizes, encoder.cfg.dilations
    with torch.inference_mode():
        h = conv_block0_reference(
            x, blk.conv.weight.permute(2, 1, 0), blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.bn.running_mean, blk.bn.running_var, blk.bn.eps, pool=blk.pool_size,
            gemm_dtype=cdt, requant_scale=qvars["s0"])
        n = len(qvars["blocks"])
        for i, q in enumerate(qvars["blocks"], start=1):
            h = quant_block_reference(h, q["w_q"], q["alpha"], q["beta"], q["gamma"],
                                      last=i == n, out_dtype=cdt, pool=max(pools[i], 1),
                                      dilation=dilations[i])
        return encoder.pool_and_embed(h.transpose(1, 2))


def run_int8_slice(sliced: dict, seed: int, phase: str = "int8_slice") -> dict:
    """The model of ``run_slice`` calibrated with ``quantize_from_store`` and
    served in int8 (B1 → B2 with requant → B3 for every block 1+), the same
    500 tasks, the launch counters read around the run, the table held
    against the plain-version int8 path and set beside the bf16 table."""
    model, cfg, store = sliced["model"], sliced["cfg"], sliced["store"]
    t0 = time.perf_counter()
    qvars = quantize_from_store(model, cfg, store, n_cal=256)
    torch.cuda.synchronize()
    calib_seconds = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    reset_counts()
    t0 = time.perf_counter()
    table = nshot.embed_all(model, store, cfg, qvars=qvars)
    acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, qvars=qvars,
                         table=table)
    launches = read_counts()
    seconds = time.perf_counter() - t0

    n_utts = store.labels.shape[0]
    chunks = -(-n_utts // 256)  # embed_all's batch_size
    if table.shape != (n_utts, cfg.encoder.embedding_dim) or table.dtype != torch.float32:
        raise AssertionError(f"int8 embedding table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError("int8 embedding table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"int8 accuracy {acc} outside [0, 1]")
    n_mid = len(qvars["blocks"])
    if (launches["gather_whiten"] == 0 or launches["conv_block0"] == 0
            or launches["quant_block"] != n_mid * chunks):
        raise AssertionError(f"int8 slice launches {launches}: want gather_whiten and "
                             f"conv_block0 > 0, quant_block = {n_mid} x {chunks} chunks")

    plain = torch.cat([quant_embed_plain(model.encoder, qvars, x)
                       for x in plain_fragments(store, cfg, n_utts)])
    cos_plain = min_cosine(table, plain)
    if cos_plain < TABLE_MIN_COSINE:
        raise AssertionError(f"int8 table vs plain path: min cosine {cos_plain}")
    tasks = sampling.sample_nshot_tasks(torch.Generator(device=DEVICE).manual_seed(seed),
                                        store.speaker_utts, store.speaker_counts, 500, 1, 5)
    pred = {name: nshot.classifier_nshot_predictions(t, tasks.query_idx, tasks.support_idx)
            for name, t in (("int8", table), ("bf16", sliced["table"]))}
    acc_again = float((pred["int8"] == 0).float().mean())
    if abs(acc_again - acc) > 1e-6:
        raise AssertionError(f"redrawn tasks score {acc_again}, evaluate gave {acc}")
    emit({"phase": phase, "config": cfg.name, "utterances": n_utts,
          "tasks": 500, "n_shot": 1, "k_way": 5, "calibration_rows": min(256, n_utts),
          "accuracy_int8": acc, "accuracy_bf16": sliced["accuracy"],
          "same_decision_share": float((pred["int8"] == pred["bf16"]).float().mean()),
          "min_cosine_int8_vs_bf16_table": min_cosine(table, sliced["table"]),
          "min_cosine_vs_plain_int8_path": cos_plain, "cosine_tolerance": TABLE_MIN_COSINE,
          "launches": launches, "calibration_seconds": calib_seconds, "seconds": seconds})
    return {"launches": launches, "qvars": qvars}


def run_fidelity_gate(store, offsets, model, seed: int, hold: bool = True,
                      phase: str = "int8_fidelity_gate",
                      config: str = "classifier_baseline") -> dict:
    """bench.py's int8 gate: calibrate on rows [0, n_cal), measure on the
    disjoint rows [n_cal, 2·n_cal) at fresh decimated offsets. With ``hold``
    a min cosine below the gate fails the run; without, as ``bench.py``
    does, the path falls back to bf16 serving and the run goes on
    (``int8_served`` says which)."""
    n_cal = 256
    rng = np.random.default_rng(seed + 1)
    max_off = store.shape[1] - FRAG
    rows = torch.arange(n_cal, dtype=torch.int32, device=DEVICE)
    x_cal = gather_whiten(store[:n_cal], rows, offsets[:n_cal], FRAG)[..., None]
    qvars = quantize_encoder(model.encoder, x_cal)
    off_fid = torch.from_numpy(rng.integers(0, max_off, n_cal).astype(np.int32)).to(DEVICE)
    x_fid = gather_whiten(store[n_cal:2 * n_cal], rows, off_fid, FRAG)[..., None]
    with torch.inference_mode():
        ref = fast_embed(model.encoder, x_fid)
        out = quant_embed(model.encoder, qvars, x_fid)
    fidelity = min_cosine(out, ref)
    served = fidelity >= INT8_FIDELITY_GATE
    emit({"phase": phase, "config": config, "calibration_rows": [0, n_cal],
          "fidelity_rows": [n_cal, 2 * n_cal], "min_cosine": fidelity,
          "gate": INT8_FIDELITY_GATE, "pass": served, "held": hold, "int8_served": served,
          "served_dtype": "int8" if served else "bfloat16"})
    if hold and not served:
        raise AssertionError(f"int8 fidelity gate: min cosine {fidelity} < {INT8_FIDELITY_GATE}")
    return {"qvars": qvars, "min_cosine": fidelity, "int8_served": served}


def in_chunks(fn, *tensors, **kw):
    """Run ``fn`` over CHECK_ROWS-row slices of the leading tensor (the plain
    versions hold full-rate f32 or f64 intermediates)."""
    def run():
        for start in range(0, tensors[0].shape[0], CHECK_ROWS):
            fn(tensors[0][start:start + CHECK_ROWS], *tensors[1:], **kw)
    return run


def time_quant_blocks(seed: int, blocks=None) -> dict:
    """Each B3 launch at ``blocks`` (config #1's by default; rows (T, Cin,
    Cout, pool, dilation, last)) and B=BATCH, beside its bound, its plain
    version and the library's int8 GEMM alone on the (dilated) patch
    matrix."""
    blocks = blocks or [(T, cin, cout, 2, 1, last) for T, cin, cout, last in QBLOCKS]
    rows = []
    for i, (T, cin, cout, pool, d, last) in enumerate(blocks):
        args = qblock_inputs(seed + i, BATCH, T, cin, cout)
        out_bytes = 2 if last else 1
        kw = dict(last=last, pool=pool, dilation=d)
        moved = (BATCH * T * cin + 3 * cin * cout + 12 * cout
                 + BATCH * (T // pool) * cout * out_bytes)
        row = {"T": T, "cin": cin, "cout": cout, "pool": pool, "dilation": d,
               "out": "bfloat16" if last else "int8",
               **bound(moved, 2.0 * BATCH * T * 3 * cin * cout, INT8_OPS_PER_S)}
        row["ms"] = time_fn(quant_block, *args, **kw, iters=20)["mean_s"] * 1e3
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_fn(in_chunks(quant_block_reference, *args, **kw),
                                  iters=2, warmup=1)["mean_s"] * 1e3
        x, w = args[0], args[1]
        try:  # library yardstick: torch._int_mm on the im2col'd input, GEMM only
            xp = torch.nn.functional.pad(x, (0, 0, d, d))
            a = torch.cat([xp[:, j * d:j * d + T] for j in range(3)],
                          dim=-1).reshape(BATCH * T, 3 * cin)
            del xp
            row["library_ms"] = time_fn(torch._int_mm, a, w.reshape(3 * cin, cout).contiguous(),
                                        iters=10)["mean_s"] * 1e3
            row["library"] = ("torch._int_mm on im2col (B*T, 3*Cin) x (3*Cin, Cout), taps d "
                              "apart, GEMM only")
            del a
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"], row["library"] = None, f"torch._int_mm refused: {e}"
        rows.append(row)
        del args, x, w
        torch.cuda.empty_cache()
    return {"blocks": rows}


def embed_cudnn_blocks(encoder, x: torch.Tensor) -> torch.Tensor:
    """The bf16 embed as it ran before B8: B2, then ``ConvBlock.forward_nct``
    (cuDNN) for every later block, then the head."""
    blk = encoder.blocks[0]
    cdt = encoder.compute_dtype
    with torch.inference_mode():
        h = conv_block0(x, *block_params(blk), blk.bn.eps, out_dtype=cdt,
                        gemm_dtype=cdt).transpose(1, 2)
        for blk in encoder.blocks[1:]:
            h = blk.forward_nct(h)
        return encoder.pool_and_embed(h)


def time_blockn(encoder, x: torch.Tensor) -> list:
    """B8 at each of the encoder's blocks 1+ (config #1's three, config #3's
    seven) at B=BATCH, on the block's own input (B2's output, then B8's),
    beside its bound, its plain version, ``F.conv1d`` in bf16 at the block's
    shape and dilation (conv and bias only: the port never calls it for B8's
    work) and the cuDNN block it replaced (``ConvBlock.forward_nct`` on the
    same input, channel first)."""
    cdt = encoder.compute_dtype
    blk0 = encoder.blocks[0]
    rows = []
    with torch.inference_mode():
        h = conv_block0(x, *block_params(blk0), blk0.bn.eps, out_dtype=cdt, gemm_dtype=cdt)
        for i, blk in enumerate(encoder.blocks[1:], start=1):
            params = block_params(blk)
            B, T, cin = h.shape
            k, _, cout = params[0].shape
            pool, d = max(blk.pool_size, 1), blk.conv.dilation[0]
            kw = dict(dilation=d)
            moved = (h.numel() * 2 + k * cin * cout * 4 + 5 * cout * 4
                     + B * (T // pool) * cout * 2)
            ops = 2.0 * B * T * k * cin * cout
            row = {"block": i, "B": B, "T": T, "cin": cin, "cout": cout, "k": k, "pool": pool,
                   "dilation": d, "ops": ops, "bytes": moved, **bound(moved, ops, BF16_OPS_PER_S),
                   "ms": time_fn(conv_blockn, h, *params, blk.bn.eps, pool, **kw,
                                 iters=20)["mean_s"] * 1e3,
                   "plain_ms": time_fn(in_chunks(conv_blockn_reference, h, *params, blk.bn.eps,
                                                 pool, **kw),
                                       iters=2, warmup=1)["mean_s"] * 1e3}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            xc = h.transpose(1, 2).contiguous()  # (B, Cin, T), the layout F.conv1d takes
            wc, bc = blk.conv.weight.to(cdt), blk.conv.bias.to(cdt)
            row["library_ms"] = time_fn(torch.nn.functional.conv1d, xc, wc, bc,
                                        padding=d * (k - 1) // 2, dilation=d,
                                        iters=20)["mean_s"] * 1e3
            row["library"] = "F.conv1d bf16 (cuDNN), conv and bias only: no relu, BN or pool"
            row["cudnn_block_ms"] = time_fn(blk.forward_nct, h.transpose(1, 2),
                                            iters=20)["mean_s"] * 1e3
            del xc
            rows.append(row)
            h = conv_blockn(h, *params, blk.bn.eps, pool, **kw)
    torch.cuda.empty_cache()
    return rows


def bench_device_store(store: torch.Tensor) -> tuple[DeviceStore, torch.Tensor]:
    """The decimated bench store as a DeviceStore of BATCH one-row speakers,
    and its row ids, for ``fetch_batch``'s random offsets."""
    lengths = torch.full((BATCH,), store.shape[1], dtype=torch.int32, device=DEVICE)
    rows = torch.arange(BATCH, dtype=torch.int32, device=DEVICE)
    return DeviceStore(audio=store, lengths=lengths, labels=rows, speaker_utts=rows[:, None],
                       speaker_counts=torch.ones_like(rows), downsampling=DS), rows


def run_timing(store, idx, offsets, params, s0, model, cfg, qvars, seed, card) -> dict:
    x = gather_whiten(store, idx, offsets, FRAG)[..., None]
    c = params[1].shape[0]
    x_bytes = BATCH * FRAG * 4
    conv_ops = 2.0 * BATCH * FRAG * c * 32
    ms = {
        "gather_whiten": time_fn(gather_whiten, store, idx, offsets, FRAG,
                                 iters=20)["mean_s"] * 1e3,
        "conv_block0": time_fn(conv_block0, x, *params, iters=20)["mean_s"] * 1e3,
        "conv_block0_int8": time_fn(conv_block0, x, *params, requant_scale=s0,
                                    iters=20)["mean_s"] * 1e3,
        "conv_block0_f32": time_fn(conv_block0, x, *params, out_dtype=torch.float32,
                                   gemm_dtype=torch.float32, iters=5)["mean_s"] * 1e3,
    }
    plain_ms = {
        "gather_whiten": time_fn(gather_whiten_reference, store, idx, offsets, FRAG,
                                 iters=10)["mean_s"] * 1e3,
        "conv_block0": time_fn(in_chunks(conv_block0_reference, x, *params),
                               iters=3, warmup=1)["mean_s"] * 1e3,
        "conv_block0_int8": time_fn(in_chunks(conv_block0_reference, x, *params,
                                              requant_scale=s0),
                                    iters=3, warmup=1)["mean_s"] * 1e3,
        "conv_block0_f32": time_fn(in_chunks(conv_block0_reference, x, *params,
                                             out_dtype=torch.float32, gemm_dtype=torch.float32),
                                   iters=2, warmup=1)["mean_s"] * 1e3,
    }
    bounds = {
        "gather_whiten": bound(BATCH * FRAG * (2 + 4) + BATCH * 8, 0.0, BF16_OPS_PER_S),
        "conv_block0": bound(x_bytes + BATCH * (FRAG // 4) * c * 2, conv_ops, BF16_OPS_PER_S),
        "conv_block0_int8": bound(x_bytes + BATCH * (FRAG // 4) * c, conv_ops, BF16_OPS_PER_S),
        # f32 products: no tensor-core type computes them, so the CUDA cores' rate
        "conv_block0_f32": bound(x_bytes + BATCH * (FRAG // 4) * c * 4, conv_ops,
                                 F32_OPS_PER_S),
    }
    # B2's yardstick: F.conv1d at (B, 1, T), conv and bias only (no relu, BN
    # or pool), in bf16 for the tensor-core kernel and in f32 (TF32 off) for
    # the f32-GEMM one; the port never calls it.
    w_nct = params[0].permute(2, 1, 0).contiguous()  # (C, 1, 32)
    b2_library = {}
    for name, dt in (("conv_block0", torch.bfloat16), ("conv_block0_f32", torch.float32)):
        b2_library[name] = time_fn(torch.nn.functional.conv1d, x.transpose(1, 2).to(dt),
                                   w_nct.to(dt), params[1].to(dt), padding="same",
                                   iters=5)["mean_s"] * 1e3
    b2_library["conv_block0_int8"] = b2_library["conv_block0"]
    b8 = time_blockn(model.encoder, x)
    # fast_embed's stages after the gather, each on the previous one's output
    stage_ms, h = {}, x
    with torch.inference_mode():
        for name, fn in stage_profile.stages_bf16(model.encoder, lambda: x)[1:]:
            stage_ms[name] = time_fn(fn, h, iters=10)["mean_s"] * 1e3
            h = fn(h)
    del x, h
    qb = time_quant_blocks(seed)
    library_ms = {"gather_whiten": None, **b2_library}
    for name, rows_ in (("quant_block", qb["blocks"]), ("conv_blockn", b8)):
        ms[name] = sum(r["ms"] for r in rows_)
        plain_ms[name] = sum(r["plain_ms"] for r in rows_)
        bounds[name] = {"bound_ms": sum(r["bound_ms"] for r in rows_),
                        "bound_by": max(rows_, key=lambda r: r["bound_ms"])["bound_by"]}
        lib = [r["library_ms"] for r in rows_]
        library_ms[name] = None if None in lib else sum(lib)

    bench, rows = bench_device_store(store)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def serve(indices):
        with torch.inference_mode():
            return fast_embed(model.encoder, fetch_batch(bench, indices, cfg, gen))

    def serve_int8(indices):
        with torch.inference_mode():
            return quant_embed(model.encoder, qvars, fetch_batch(bench, indices, cfg, gen))

    def serve_plain(indices):
        with torch.inference_mode():
            offs = torch.zeros_like(indices)
            xp = gather_whiten_reference(store, indices, offs, FRAG)[..., None]
            return model.embed(xp)

    def serve_cudnn(indices):
        return embed_cudnn_blocks(model.encoder, fetch_batch(bench, indices, cfg, gen))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tput = throughput(serve, rows, items_per_call=BATCH, iters=10, warmup=2)
    peak_bf16 = torch.cuda.max_memory_allocated() / 1e9
    # bf16 through B8 against the cuDNN blocks it replaced, in turns.
    turns = [{"blocks": name, "ms_b2048": throughput(fn, rows, items_per_call=BATCH, iters=5,
                                                     warmup=1)["sec_per_call"] * 1e3}
             for name, fn in (("b8", serve), ("cudnn", serve_cudnn), ("cudnn", serve_cudnn),
                              ("b8", serve))]
    tput_int8 = throughput(serve_int8, rows, items_per_call=BATCH, iters=10, warmup=2)
    tput_plain = throughput(serve_plain, rows, items_per_call=BATCH, iters=3, warmup=1)
    one = rows[:1]
    lat = time_fn(serve, one, iters=50, warmup=5)
    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        serve(one)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    # int8 against bf16, store -> embedding, in turns at each batch size.
    sweep = []
    for b in SWEEP:
        iters = 5 if b >= 1024 else 20
        t_bf16 = time_fn(serve, rows[:b], iters=iters, warmup=2)["mean_s"]
        t_int8 = time_fn(serve_int8, rows[:b], iters=iters, warmup=2)["mean_s"]
        sweep.append({"batch": b, "bf16_ms": t_bf16 * 1e3, "int8_ms": t_int8 * 1e3,
                      "int8_over_bf16": t_int8 / t_bf16})
    faster = [r["batch"] for r in sweep if r["int8_ms"] < r["bf16_ms"]]
    min_batch = next((b for b in SWEEP if all(r["int8_ms"] < r["bf16_ms"]
                                              for r in sweep if r["batch"] >= b)), None)
    b8_ms = [t["ms_b2048"] for t in turns if t["blocks"] == "b8"]
    cudnn_ms = [t["ms_b2048"] for t in turns if t["blocks"] == "cudnn"]
    emit({"phase": "timing", "card": card, "kernel_ms": ms, "plain_ms": plain_ms,
          "bound": bounds, "library_ms": library_ms, "quant_block": qb["blocks"],
          "conv_blockn": b8, "bf16_stage_ms": stage_ms,
          "conv_block0_library": "F.conv1d (cuDNN) at (B, 1, T), conv and bias only: bf16 "
                                 "for the tensor-core kernel (bf16 and int8 out), f32 with "
                                 "TF32 off for the f32-GEMM kernel",
          "embed_utt_per_s_b2048": tput["items_per_sec"],
          "embed_ms_b2048": tput["sec_per_call"] * 1e3, "bf16_peak_mem_gb": peak_bf16,
          "b8_against_cudnn_blocks_turns": turns,
          "embed_ms_b2048_b8_blocks": sum(b8_ms) / len(b8_ms),
          "embed_ms_b2048_cudnn_blocks": sum(cudnn_ms) / len(cudnn_ms),
          "int8_embed_utt_per_s_b2048": tput_int8["items_per_sec"],
          "int8_embed_ms_b2048": tput_int8["sec_per_call"] * 1e3,
          "plain_path_utt_per_s_b2048": tput_plain["items_per_sec"],
          "batch1_p50_ms_events": lat["p50_s"] * 1e3,
          "batch1_p95_ms_events": lat["p95_s"] * 1e3,
          "batch1_p50_ms_host": float(np.median(host)) * 1e3,
          "int8_vs_bf16_sweep": sweep, "int8_faster_at": faster,
          "int8_min_batch_measured": min_batch,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"ms": ms, "plain_ms": plain_ms, "bounds": bounds, "library_ms": library_ms,
            "b3_library": [r["library_ms"] for r in qb["blocks"]]}


def run_attribution(seed: int, card: str, b3_library: list) -> dict:
    """``utils/qblock_attrib`` at config #1's block shapes and B=BATCH: B10's
    stages and B3, the launch counters read around it; then the mma stage
    beside its plain version and its bound (its output is int32), and B3's
    library GEMM (``time_quant_blocks``) as its yardstick."""
    t0 = time.perf_counter()
    reset_counts()
    rows = qblock_attrib.attribute(BATCH, seed, QBLOCKS, device=DEVICE, timer=time_fn)
    launches = read_counts()
    if launches["quant_block_stage"] == 0:
        raise AssertionError(f"attribution launches {launches}: want quant_block_stage")
    for i, (row, (T, cin, cout, _)) in enumerate(zip(rows, QBLOCKS)):
        args = qblock_inputs(seed + i, BATCH, T, cin, cout)
        row["mma_plain_ms"] = time_fn(in_chunks(quant_block_stage_reference, *args, "mma"),
                                      iters=2, warmup=1)["mean_s"] * 1e3
        moved = BATCH * T * cin + 3 * cin * cout + 12 * cout + BATCH * (T // 2) * cout * 4
        row["mma_bound"] = bound(moved, row["ops"], INT8_OPS_PER_S)
        del args
        torch.cuda.empty_cache()
    emit({"phase": "attribution", "card": card, "blocks": rows, "launches": launches,
          "seconds": time.perf_counter() - t0})
    worst = max(rows, key=lambda r: r["mma_bound"]["bound_ms"])
    return {"launches": launches,
            "ms": {"quant_block_stage": sum(r["stages"][0]["ms"] for r in rows)},
            "plain_ms": {"quant_block_stage": sum(r["mma_plain_ms"] for r in rows)},
            "bounds": {"quant_block_stage": {
                "bound_ms": sum(r["mma_bound"]["bound_ms"] for r in rows),
                "bound_by": worst["mma_bound"]["bound_by"]}},
            "library_ms": {"quant_block_stage": None if None in b3_library else sum(b3_library)}}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / (scale if scale > 0 else 1.0)


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    err = rel_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name} {tuple(want.shape)}: {err} of max |value| > {tol}")
    return {"kernel": name, "shape": list(want.shape),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rel_err": err, "tolerance": f"<= {tol} of max |value|"}


def block0_train_inputs(seed: int, B: int, T: int, c: int) -> tuple:
    """B4/B5's parameters beside ``x``: w, b, sgn (γ of both signs), a pooled
    cotangent and the three dz constants."""
    w, b, scale = block0_params(seed, c)[:3]
    sgn = torch.where(scale >= 0, 1.0, -1.0)
    g = torch.Generator().manual_seed(seed)
    cot = torch.randn(B, T // 4, c, generator=g).to(DEVICE)
    c0, c1, c2 = (torch.randn(c, generator=g).mul(s).to(DEVICE) for s in (1.0, 0.1, 0.05))
    return w, b, sgn, cot, c0, c1, c2


def routing_inputs(seed: int, B: int, c: int, T: int, pool: int, dtype,
                   rows: str = "plain") -> tuple:
    """B7's inputs as the train op hands them, channels last ((B, C, T)
    tensors with (B, T, C) memory): a raw conv output z in ``dtype`` (both
    signs; with the bias of both signs, ~half of the activation is 0), the
    bias, sgn of both signs, a pooled f32 cotangent and the dz constants.
    ``rows="scaled"``: batch rows × ROW_SCALES in turn; ``rows="ties"``: z
    on a coarse grid, so that phases tie exactly. Made on the card, from a
    generator there."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    z = torch.randn(B, T, c, generator=g, device=DEVICE)
    if rows == "scaled":
        z *= torch.tensor(ROW_SCALES, device=DEVICE).repeat(B)[:B, None, None]
    elif rows == "ties":
        z = torch.round(z * 2.0) / 2.0
    z = z.to(dtype).permute(0, 2, 1)
    b = torch.randn(c, generator=g, device=DEVICE) * 0.5
    sgn = torch.where(torch.arange(c, device=DEVICE) % 3 == 1, -1.0, 1.0)
    cot = torch.randn(B, T // pool, c, generator=g, device=DEVICE).permute(0, 2, 1)
    c0, c1, c2 = (torch.randn(c, generator=g, device=DEVICE) * s for s in (1.0, 0.1, 0.05))
    return z, b, sgn, cot, c0, c1, c2


def b45_edge_inputs(seed: int, B: int, T: int, c: int, rows: str) -> tuple:
    """x (B, T, 1) for B4/B5's edges and the parameters beside it (those of
    ``block0_train_inputs``): ``rows="scaled"`` multiplies the batch rows
    by ROW_SCALES in turn; ``rows="ties"`` puts x on a grid of 1/4 with a
    silent stretch in each row and w on a grid of 1/8, so that every sum is
    exact in any order and phases tie exactly."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, 1, generator=g) * 0.3
    params = list(block0_train_inputs(seed, B, T, c))
    if rows == "scaled":
        x = scaled_rows(x)
    elif rows == "ties":
        x = torch.round(x * 4) / 4
        x[:, T // 4:T // 4 + 200] = 0.0
        params[0] = torch.round(params[0] * 8) / 8
    return (x.to(DEVICE), *params)


def relu_mask_flips(relu: torch.Tensor, p_relu: torch.Tensor, z: torch.Tensor,
                    bound: torch.Tensor) -> int:
    """B5's relu masks (``relu_bits``) against the plain version's: a phase
    may differ only where its pre-activation lies within its bound of 0.
    Returns the count of such phases; raises ``AssertionError`` else."""
    B, c, T = z.shape
    moved = torch.stack([((relu ^ p_relu) >> j) & 1 for j in range(4)], -1).bool()
    near = (z.abs() <= bound).view(B, c, T // 4, 4).transpose(1, 2)
    if bool((moved & ~near).any()):
        raise AssertionError("B5's relu masks differ from the plain version's where no "
                             "pre-activation lies within its bound of 0")
    return int(moved.sum())


def check_block0_train_f32(x: torch.Tensor, params: tuple, rows: str = "plain") -> tuple[list, dict]:
    """B4 and B5's f32 route (the conv and B5's dW in 3xTF32 on the tensor
    cores) against their plain versions, each to its stated tolerance
    (above B45_MIN_COSINE): a_sel in f32 within its order bound at the
    3xTF32 unit, in bf16 within it before its rounding; #(a > 0), B5's
    routes and relu masks flipping only within it, the flips counted;
    stats to TRAIN_REL_TOL, dW and db to it on B5's own routes and masks;
    B5's recomputed selection equal to B4's f32 a_sel bit for bit."""
    B, T = x.shape[0], x.shape[1]
    w, b, sgn, cot, c0, c1, c2 = params
    f32, bf = torch.float32, torch.bfloat16
    c = w.shape[2]
    shape = (B, T // 4, c)
    got = conv_block0_train(x, w, b, sgn, 4, f32, f32)
    gotb = conv_block0_train(x, w, b, sgn, 4, f32, bf)
    want = conv_block0_train_reference(x, w, b, sgn, 4, f32, f32)
    torch.cuda.synchronize()
    for out, dt in ((got[0], f32), (gotb[0], bf)):
        if tuple(out.shape) != shape or out.dtype != dt:
            raise AssertionError(f"conv_block0_train {shape}: {tuple(out.shape)} {out.dtype}")
    if not all(torch.equal(u, v) for u, v in zip(got[1:], gotb[1:])):
        raise AssertionError("conv_block0_train: the statistics differ between two launches")
    tiny = torch.full((), 1e-30, dtype=torch.float64, device=x.device)
    bnd = block0_train_tc.sel_bound(x, w, b, want[0], f32)
    diff = (got[0] - want[0]).abs()
    ratio = float((diff / torch.maximum(bnd, tiny)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"conv_block0_train {shape} f32 GEMM, f32 a_sel: {ratio} of its "
                             f"order bound")
    tolb = (1 + B2_BF16_REL) * bnd + B2_BF16_REL * want[0].abs().double()
    ratio_b = float(((gotb[0].float() - want[0]).abs() / torch.maximum(tolb, tiny)).max())
    if not ratio_b <= 1.0:
        raise AssertionError(f"conv_block0_train {shape} f32 GEMM, bf16 a_sel: {ratio_b} of its "
                             f"bound")
    z, zb = block0_train_tc.preactivation(x, w, b, f32)
    relu = block0_train_tc.relu_flips(got[3], want[3], z, zb)
    stats = [check_rel("conv_block0_train", g_, w_, TRAIN_REL_TOL)
             for g_, w_ in zip(got[1:3], want[1:3])]
    dw, db = conv_block0_train_bwd(x, w, b, sgn, cot, c0, c1, c2, 4, f32)
    sdw, sdb, ssel, route, relu_b = conv_block0_train_bwd_stage(x, w, b, sgn, cot, c0, c1, c2,
                                                                4, f32)
    if not (torch.equal(ssel, got[0]) and torch.equal(sdw, dw) and torch.equal(sdb, db)):
        raise AssertionError(f"conv_block0_train_bwd_stage {shape} f32 GEMM: B5's recomputed "
                             f"selection is not B4's a_sel bit for bit, or its dW, db not B5's")
    routes = block0_train_tc.route_flips(route, z, zb, sgn)
    p_relu = relu_bits(z.clamp(min=0.0))
    relus = relu_mask_flips(relu_b, p_relu, z, zb)
    del z, zb
    own_dw, own_db = conv_block0_train_bwd_routed_reference(x, w, b, sgn, cot, c0, c1, c2,
                                                            route, relu_b, 4, f32)
    want_dw, want_db = conv_block0_train_bwd_reference(x, w, b, sgn, cot, c0, c1, c2, 4, f32)
    grads = [check_rel("conv_block0_train_bwd", dw, own_dw, TRAIN_REL_TOL),
             check_rel("conv_block0_train_bwd", db, own_db, TRAIN_REL_TOL)]
    for ch, got_, want_ in zip(grads, (dw, db), (want_dw, want_db)):
        ch.update(reference="plain dW, db on B5's own routes and relu masks",
                  rel_err_vs_plain_routes=rel_err(got_, want_))
    base = {"route": "float32 GEMM", "B": B, "rows": rows}
    unit = block0_train_tc.tf32x3_unit()
    checks = [{**base, "kernel": "conv_block0_train", "shape": list(shape), "dtype": "float32",
               "max_abs_err": float(diff.max()), "err_over_bound": ratio,
               "tolerance": f"|err| <= u*(4*K*(S+|bias|) + 4*|ref|), u = {unit} "
                            f"(3xTF32), K = 32, S = sum|x*w| of the larger phase"},
              {**base, "kernel": "conv_block0_train", "shape": list(shape), "dtype": "bfloat16",
               "max_abs_err": float((gotb[0].float() - want[0]).abs().max()),
               "err_over_bound": ratio_b,
               "tolerance": "|out - ref_f32| <= (1 + 2^-8)*bound + 2^-8*|ref_f32|"},
              {**base, "kernel": "conv_block0_train", "shape": [c], "dtype": "count",
               "max_abs_err": float((got[3] - want[3]).abs().max()), "flips": relu,
               "tolerance": "#(a > 0) differs only by pre-activations within their bound "
                            "of 0"},
              *({**base, **ch} for ch in stats + grads),
              {**base, "kernel": "conv_block0_train_bwd_stage", "shape": list(shape),
               "max_abs_err": 0.0, "route_flips": routes, "relu_flips": relus,
               "tolerance": "selection equal to B4's f32 a_sel bit for bit; routes and relu "
                            "masks differ only within their bounds"}]
    errors = {"conv_block0_train_f32": max(float(diff.max()), stats[0]["max_abs_err"],
                                           stats[1]["max_abs_err"]),
              "conv_block0_train_bwd_f32": max(ch["max_abs_err"] for ch in grads)}
    return checks, errors


def check_block0_train(x: torch.Tensor, params: tuple, rows: str = "plain") -> tuple[list, dict]:
    """B4 and B5 on the tensor cores (bf16 GEMM) against their plain
    versions, each to its stated tolerance (B45_MIN_COSINE above), and B5's
    recomputed selection against B4's a_sel bit for bit."""
    B, T = x.shape[0], x.shape[1]
    w, b, sgn, cot, c0, c1, c2 = params
    c = w.shape[2]
    shape = (B, T // 4, c)
    bf = torch.bfloat16
    got = conv_block0_train(x, w, b, sgn, 4, bf, torch.float32)
    gotb = conv_block0_train(x, w, b, sgn, 4, bf, bf)
    want = conv_block0_train_reference(x, w, b, sgn, 4, bf, torch.float32)
    wantb = conv_block0_train_reference(x, w, b, sgn, 4, bf, bf)
    torch.cuda.synchronize()
    for out, dt in ((got[0], torch.float32), (gotb[0], bf)):
        if tuple(out.shape) != shape or out.dtype != dt:
            raise AssertionError(f"conv_block0_train {shape}: {tuple(out.shape)} {out.dtype}")
    if not all(torch.equal(u, v) for u, v in zip(got[1:], gotb[1:])):
        raise AssertionError("conv_block0_train: the statistics differ between two launches")
    tiny = torch.full((), 1e-30, dtype=torch.float64, device=x.device)
    bnd = block0_train_tc.sel_bound(x, w, b, want[0])
    diff = (got[0] - want[0]).abs()
    ratio = float((diff / torch.maximum(bnd, tiny)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"conv_block0_train {shape} f32 a_sel: {ratio} of its order bound")
    tolb = (1 + B2_BF16_REL) * bnd + B2_BF16_REL * want[0].abs().double()
    ratio_b = float(((gotb[0].float() - want[0]).abs() / torch.maximum(tolb, tiny)).max())
    cos = min_cosine(gotb[0].reshape(B, -1).float(), wantb[0].reshape(B, -1).float())
    if not (ratio_b <= 1.0 and cos >= B45_MIN_COSINE):
        raise AssertionError(f"conv_block0_train {shape} bf16 a_sel: {ratio_b} of its bound, "
                             f"row cosine {cos}")
    z, zb = block0_train_tc.preactivation(x, w, b)
    relu = block0_train_tc.relu_flips(got[3], want[3], z, zb)
    stats = [check_rel("conv_block0_train", g_, w_, TRAIN_REL_TOL)
             for g_, w_ in zip(got[1:3], want[1:3])]
    dw, db = conv_block0_train_bwd(x, w, b, sgn, cot, c0, c1, c2, 4, bf)
    sdw, sdb, ssel, route, _ = conv_block0_train_bwd_stage(x, w, b, sgn, cot, c0, c1, c2)
    want_dw, want_db = conv_block0_train_bwd_reference(x, w, b, sgn, cot, c0, c1, c2, 4, bf)
    grads = [check_rel("conv_block0_train_bwd", dw, want_dw, TRAIN_REL_TOL),
             check_rel("conv_block0_train_bwd", db, want_db, TRAIN_REL_TOL)]
    if not (torch.equal(ssel, got[0]) and torch.equal(sdw, dw) and torch.equal(sdb, db)):
        raise AssertionError(f"conv_block0_train_bwd_stage {shape}: B5's recomputed selection "
                             f"is not B4's a_sel bit for bit, or its dW, db not B5's")
    routes = block0_train_tc.route_flips(route, z, zb, sgn)
    del z, zb
    base = {"route": "tensor cores", "B": B, "rows": rows}
    checks = [{**base, "kernel": "conv_block0_train", "shape": list(shape), "dtype": "float32",
               "max_abs_err": float(diff.max()), "err_over_bound": ratio,
               "tolerance": "|err| <= u*(4*K*(S+|bias|) + 4*|ref|), u = 2^-24, K = 32, "
                            "S = sum|x*w| of the larger phase"},
              {**base, "kernel": "conv_block0_train", "shape": list(shape), "dtype": "bfloat16",
               "max_abs_err": float((gotb[0].float() - wantb[0].float()).abs().max()),
               "err_over_bound": ratio_b, "min_row_cosine": cos,
               "max_ulps_vs_plain_bf16": bf16_ulps(gotb[0], wantb[0]),
               "tolerance": f"|out - ref_f32| <= (1 + 2^-8)*bound + 2^-8*|ref_f32|; row cosine "
                            f">= {B45_MIN_COSINE}"},
              {**base, "kernel": "conv_block0_train", "shape": [c], "dtype": "count",
               "max_abs_err": float((got[3] - want[3]).abs().max()), "flips": relu,
               "tolerance": "#(a > 0) differs only by pre-activations within their bound "
                            "of 0"},
              *({**base, **ch} for ch in stats + grads),
              {**base, "kernel": "conv_block0_train_bwd_stage", "shape": list(shape),
               "max_abs_err": 0.0, "route_flips": routes,
               "tolerance": "selection equal to B4's f32 a_sel bit for bit; routes differ "
                            "only where two phases tie within their bounds"}]
    errors = {"conv_block0_train": max(float(diff.max()), stats[0]["max_abs_err"],
                                       stats[1]["max_abs_err"]),
              "conv_block0_train_bwd": max(ch["max_abs_err"] for ch in grads)}
    return checks, errors


def b5_step_inputs(seed: int) -> dict:
    """B5's arguments in one classifier train step, the step of
    ``compare_plain_step`` (and ``step_attrib.py``) at ``seed``: the
    seed's 40-speaker store, weights and batch. Two captures: with every
    other train kernel plain (step_attrib's ``b5`` variants) and with the
    kernels (its ``all``, the step check's), whose B4 and B7 hand B5 other
    inputs."""
    host = synthetic_store(seed, **SLICE_STORE)
    cfg = train_config(seed)
    store = device_store_for(cfg, host, DEVICE)
    model, run = classifier_step(cfg, host, store, seed)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    captured = {}
    for upstream in ("plain", "kernels"):
        seen = []
        real = cuda_conv_train.conv_block0_train_bwd if upstream == "kernels" else \
            conv_block0_train_bwd_reference

        def record(*args, _real=real, **kw):
            # copies: the optimizer step updates the weights in place after
            seen.append((tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args),
                         kw))
            return _real(*args, **kw)

        model.load_state_dict(snapshot)
        with plain_kernels() if upstream == "plain" else contextlib.nullcontext():
            saved = cuda_conv_train.conv_block0_train_bwd
            # the wrapper counts its launches on whatever its module's name holds
            record.__dict__.update(vars(conv_block0_train_bwd))
            cuda_conv_train.conv_block0_train_bwd = record
            try:
                run(init_state(model, cfg.train.clipnorm, cfg.train.learning_rate))
            finally:
                cuda_conv_train.conv_block0_train_bwd = saved
        if len(seen) != 1:
            raise AssertionError(f"the step called B5 {len(seen)} times, want 1")
        captured[upstream] = seen[0]
    return captured


def check_b5_step(seed: int) -> tuple[list, dict]:
    """B5 (bf16 GEMM) at a train step's own inputs (both captures of
    ``b5_step_inputs``): its dW and db to TRAIN_REL_TOL against the plain dW
    and db on the routes and relu masks B5 itself took (its stage entry
    reports them), the routing and relu flips against the plain version
    counted and each within its bound, and the gap to the plain dW on the
    plain version's own routes reported."""
    records, worst = [], 0.0
    for upstream, (args, kw) in b5_step_inputs(seed).items():
        record = b5_step_case(args, kw)
        record.update(seed=seed, upstream=upstream)
        worst = max(worst, max(ch["max_abs_err"] for ch in record["checks"]))
        records.append(record)
    return records, {"conv_block0_train_bwd": worst}


def dw_float64(x, w, b, sgn, g, c0, c1, c2, route, relu) -> torch.Tensor:
    """B5's dW on given routes and relu masks with the products of the bf16
    operands (exact in float64) summed in float64: the sum both orders
    approximate."""
    dz, xp = bwd_dz(x, w, b, sgn, g, c0, c1, c2, 4, torch.bfloat16, route, relu)
    dzr, xp = dz.to(torch.bfloat16).double(), xp.double()
    T = dz.shape[2]
    return torch.stack([torch.einsum("bt,bct->c", xp[:, j:j + T], dzr)
                        for j in range(w.shape[0])])[:, None, :]


def b5_step_case(args: tuple, kw: dict) -> dict:
    """One capture of ``check_b5_step``: B5 and its stage entry on ``args``,
    held against the plain dW and db on B5's own routes and relu masks."""
    x, w, b, sgn, g, c0, c1, c2 = args[:8]
    gemm = args[9] if len(args) > 9 else kw.get("gemm_dtype", torch.bfloat16)
    if gemm != torch.bfloat16:
        raise AssertionError(f"the train step ran B5 with a {gemm} GEMM, want bfloat16")
    dw, db = conv_block0_train_bwd(*args, **kw)
    sdw, sdb, _, route, relu = conv_block0_train_bwd_stage(x, w, b, sgn, g, c0, c1, c2)
    if not (torch.equal(sdw, dw) and torch.equal(sdb, db)):
        raise AssertionError("conv_block0_train_bwd_stage: dW, db not B5's at the step inputs")
    want_dw, want_db = conv_block0_train_bwd_reference(*args, **kw)
    own_dw, own_db = conv_block0_train_bwd_routed_reference(x, w, b, sgn, g, c0, c1, c2,
                                                            route, relu)
    _, _, _, p_route, p_relu = conv_block0_train_bwd_stage_reference(x, w, b, sgn, g, c0, c1,
                                                                       c2)
    z, zb = block0_train_tc.preactivation(x, w, b)
    routes = block0_train_tc.route_flips(route, z, zb, sgn)
    relus = relu_mask_flips(relu, p_relu, z, zb)
    B = z.shape[0]
    del z, zb
    exact = dw_float64(x, w, b, sgn, g, c0, c1, c2, route, relu)
    grads = [check_rel("conv_block0_train_bwd", dw, own_dw, TRAIN_REL_TOL),
             check_rel("conv_block0_train_bwd", db, own_db, TRAIN_REL_TOL)]
    for ch, got, want in zip(grads, (dw, db), (want_dw, want_db)):
        ch.update(route="tensor cores", B=B, rows="train step",
                  reference="plain dW, db on B5's own routes and relu masks",
                  rel_err_vs_plain_routes=rel_err(got, want))
    grads[0].update(rel_err_vs_float64=rel_err(dw, exact),
                    plain_rel_err_vs_float64=rel_err(own_dw, exact))
    return {"kernel": "conv_block0_train_bwd", "case": "b5_step", "shape": list(g.shape),
            "route_flips": routes, "relu_flips": relus,
            "route_differs": int((route != p_route).sum()), "checks": grads}


def check_routing(seed: int, B: int, c: int, T: int, pool: int, dt,
                  rows: str = "plain") -> tuple[list, dict]:
    """B7 forward and backward on a raw conv output and its bias against
    their plain versions: a_sel and dz 0 ulps (bf16) or equal (f32), both
    channels last, stats and db to TRAIN_REL_TOL."""
    z, b, sgn, cot, c0, c1, c2 = routing_inputs(seed, B, c, T, pool, dt, rows)
    sel, s1, s2 = pool_fwd(z, b, sgn, pool, dt)
    want = pool_fwd_reference(z, b, sgn, pool, dt)
    checks = [check_exact("pool_fwd", sel, want[0], (B, c, T // pool)),
              check_rel("pool_fwd", s1, want[1], TRAIN_REL_TOL),
              check_rel("pool_fwd", s2, want[2], TRAIN_REL_TOL)]
    dz, db = route_bwd(z, b, sel, cot, c0, c1, c2, pool, dt)
    want_dz, want_db = route_bwd_reference(z, b, sel, cot, c0, c1, c2, pool, dt)
    checks += [check_exact("route_bwd", dz, want_dz, (B, c, T)),
               check_rel("route_bwd", db, want_db, TRAIN_REL_TOL)]
    if not (is_channels_last(sel) and is_channels_last(dz)):
        raise AssertionError(f"B7 outputs not channels last: {sel.stride()}, {dz.stride()}")
    for ch in checks:
        ch.update(B=B, pool=pool, rows=rows)
    errors = {"pool_fwd": max(ch["max_abs_err"] for ch in checks[:3]),
              "route_bwd": max(ch["max_abs_err"] for ch in checks[3:])}
    return checks, errors


def check_routing_idx(seed: int, B: int, c: int, T: int, pool: int, dt, rows: str = "plain",
                      sel_dt=None) -> list:
    """B7's phase-index mode against its plain version: a_sel and idx equal,
    the selection equal to the value mode's kernel output, the routing by
    idx's dz bit for bit, stats and db to TRAIN_REL_TOL; ``sel_dt`` (the
    GEMM dtype) where it differs from the activation's, as the
    pool-rate-residual forward pools an f32 activation into a bf16 a_sel."""
    z, b, sgn, cot, c0, c1, c2 = routing_inputs(seed, B, c, T, pool, dt, rows)
    sel_dt = sel_dt or dt
    sel, s1, s2, ix = pool_fwd(z, b, sgn, pool, sel_dt, want_idx=True)
    want = pool_fwd_reference(z, b, sgn, pool, sel_dt, want_idx=True)
    shape = (B, c, T // pool)
    checks = [check_exact("pool_fwd_idx", sel, want[0], shape),
              check_exact("pool_fwd_idx", ix, want[3], shape),
              check_exact("pool_fwd_idx", sel, pool_fwd(z, b, sgn, pool, sel_dt)[0], shape),
              check_rel("pool_fwd_idx", s1, want[1], TRAIN_REL_TOL),
              check_rel("pool_fwd_idx", s2, want[2], TRAIN_REL_TOL)]
    dz, db = route_bwd(z, b, ix, cot, c0, c1, c2, pool, dt)
    want_dz, want_db = route_bwd_reference(z, b, ix, cot, c0, c1, c2, pool, dt)
    checks += [check_exact("route_bwd_idx", dz, want_dz, (B, c, T)),
               check_rel("route_bwd_idx", db, want_db, TRAIN_REL_TOL)]
    if not (is_channels_last(ix) and is_channels_last(dz)):
        raise AssertionError(f"B7 index mode outputs not channels last: {ix.stride()}")
    for ch in checks:
        ch.update(B=B, pool=pool, rows=rows, mode="idx")
    return checks


EPILOGUE_RATE = 0.05  # config #1's dropout


def epilogue_shapes() -> list:
    """``(T', C)`` of config #1's four pool-rate outputs at the train
    kernels' sizes: block 0's ``(FRAG / 4, TRAIN_C0)`` and blocks 1-3's
    ``(T / 2, C)``."""
    return [(FRAG // 4, TRAIN_C0)] + [(T // 2, c) for c, T in TRAIN_BLOCKS]


def epilogue_inputs(seed: int, B: int, tp: int, c: int) -> tuple:
    """The BatchNorm epilogue pair's inputs as a fused block hands them: a
    bf16 relu ``a_sel (B, T', C)``, per-channel μ, r, γ·r (γ of both signs)
    and β, a bf16 cotangent of ``y`` and a keep mask at EPILOGUE_RATE."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    sel = (torch.randn(B, tp, c, generator=g, device=DEVICE) * 1.5 + 0.3).relu().to(
        torch.bfloat16)
    mu = torch.rand(c, generator=g, device=DEVICE) * 0.5 + 0.4
    r = torch.rand(c, generator=g, device=DEVICE) + 0.5
    gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
    gamma[::3] *= -1.0
    beta = torch.randn(c, generator=g, device=DEVICE) * 0.1
    gy = torch.randn(B, tp, c, generator=g, device=DEVICE).to(torch.bfloat16)
    mask = torch.empty(B, c, device=DEVICE).bernoulli_(1.0 - EPILOGUE_RATE, generator=g)
    return sel, mu, r, gamma * r, beta, gy, mask


def epilogue_sum_depth(B: int, tp: int, c: int, vec: int) -> int:
    """The most f32 additions a term of ``bn_grad``'s per-channel sums goes
    through on the card: its thread's share of a strip, the CTA's fold over
    its position rows, and fold.cuh's over the B·strips partial rows (a
    split of 8, then the 8 in order). On the CPU the plain version's
    ``torch.sum`` folds in an order of its own: B·T', which bounds any."""
    if torch.device(DEVICE).type != "cuda":
        return B * tp
    slots = cuda_routing._sms(torch.cuda.current_device()) * cuda_routing.GRAD_CTAS_PER_SM
    strips, span = cuda_routing.launch_plan(B, c, tp, 1, vec, slots)
    rows = cuda_routing.THREADS // min(c // vec, cuda_routing.THREADS)
    return -(-span // rows) + rows + -(-B * strips // 8) + 8


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def check_bn_epilogue(B: int) -> list:
    """``bn_apply`` and ``bn_grad`` at the four pool-rate shapes, batch B,
    bf16 with a keep mask at EPILOGUE_RATE, against their plain versions (the
    eager chain they replaced) in CHECK_ROWS chunks: ``y`` and the f32
    cotangent ``g'`` bit for bit; Σg' and Σg'·â each within
    γ_d·Σ|term| of the float64 sum of the plain terms (the same f32 terms:
    only the order of the sum differs), d the kernel's summation depth and
    γ_d = d·u / (1 − d·u)."""
    keep = 1.0 - EPILOGUE_RATE
    checks = []
    for i, (tp, c) in enumerate(epilogue_shapes()):
        sel, mu, r, scale, beta, gy, mask = epilogue_inputs(60 + i, B, tp, c)
        vec = cuda_routing.vector_width(c, torch.bfloat16, sel, gy)
        y = bn_apply(sel, mu, scale, beta, mask, keep, torch.bfloat16)
        g, s1, s2 = bn_grad(gy, sel, mask, keep, mu, r)
        torch.cuda.synchronize()
        if y.shape != sel.shape or g.shape != sel.shape or g.dtype != torch.float32:
            raise AssertionError(f"bn_apply/bn_grad {(B, tp, c)}: {y.shape}, {g.shape} {g.dtype}")
        sums = torch.zeros(4, c, dtype=torch.float64, device=DEVICE)  # Σ, Σ|·| of both terms
        y_err = g_err = 0.0
        for lo in range(0, B, CHECK_ROWS):
            rows = slice(lo, lo + CHECK_ROWS)
            want_y = bn_apply_reference(sel[rows], mu, scale, beta, mask[rows], keep,
                                        torch.bfloat16)
            want_g = bn_grad_reference(gy[rows], sel[rows], mask[rows], keep, mu, r)[0]
            if not (same_bits(y[rows], want_y) and same_bits(g[rows], want_g)):
                raise AssertionError(f"bn_apply/bn_grad {(B, tp, c)} rows {lo}+: not bit for "
                                     f"bit the eager chain's")
            y_err = max(y_err, float((y[rows].float() - want_y.float()).abs().max()))
            g_err = max(g_err, float((g[rows] - want_g).abs().max()))
            terms = want_g * ((sel[rows].float() - mu) * r)
            for k, t in enumerate((want_g, terms)):
                sums[2 * k] += t.double().sum((0, 1))
                sums[2 * k + 1] += t.double().abs().sum((0, 1))
            del want_y, want_g, terms
        depth = epilogue_sum_depth(B, tp, c, vec)
        u = F32_UNIT_ROUNDOFF
        gamma_d = depth * u / (1.0 - depth * u)
        errs = [(got.double() - sums[2 * k]).abs() for k, got in enumerate((s1, s2))]
        ratio = max(float((e / (gamma_d * sums[2 * k + 1]).clamp(min=1e-300)).max())
                    for k, e in enumerate(errs))
        if not ratio <= 1.0:
            raise AssertionError(f"bn_grad {(B, tp, c)}: the sums at {ratio} of their order "
                                 f"bound (depth {depth})")
        shape = [B, tp, c]
        checks += [{"kernel": "bn_apply", "dtype": "bfloat16", "shape": shape,
                    "rate": EPILOGUE_RATE, "max_abs_err": y_err,
                    "tolerance": "bit for bit the eager chain's y"},
                   {"kernel": "bn_grad", "dtype": "bfloat16", "shape": shape,
                    "rate": EPILOGUE_RATE, "max_abs_err": g_err,
                    "sums_max_abs_err": max(float(e.max()) for e in errs),
                    "sums_err_over_bound": ratio, "sum_depth": depth,
                    "tolerance": "g' bit for bit; each sum within d*u/(1-d*u) of its "
                                 "sum of |term| of the float64 sum"}]
        del sel, gy, y, g
        torch.cuda.empty_cache()
    return checks


def qtrain_inputs(seed: int, B: int, T: int, cin: int, cout: int) -> tuple:
    """B3's train epilogue's inputs as the int8 train op forms them: bf16
    activations and fan-in-scaled weights through ``quantize_int8`` (the
    in-step scales), and a conv bias."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(B, T, cin, generator=g, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(cout, cin, 3, generator=g, device=DEVICE) * (3 * cin) ** -0.5
    b = torch.randn(cout, generator=g, device=DEVICE) * 0.05
    qx, qw, scale = quantize_int8(x, w)
    return qx, qw, scale, b


def check_qtrain(args: tuple, dilation: int = 1, out_dtype=torch.bfloat16) -> dict:
    """B3's train epilogue against its plain version, bit for bit (exact
    int32 sums, the same f32 epilogue ops)."""
    qx, qw = args[:2]
    B, T = qx.shape[:2]
    out = quant_block_train(*args, out_dtype, dilation)
    ref = torch.cat([quant_block_train_reference(qx[i:i + CHECK_ROWS], *args[1:], out_dtype,
                                                 dilation)
                     for i in range(0, B, CHECK_ROWS)]) if B else out
    c = check_exact("quant_block_train", out, ref, (B, T, qw.shape[2]))
    return {**c, "cin": qx.shape[2], "dilation": dilation,
            "relu_zeros": float((ref == 0).float().mean()) if ref.numel() else 0.0}


def check_blockn_rows(seed: int, B: int, T: int, cin: int, cout: int) -> dict:
    """B8 at pool 1, f32 out, rows (b, 1, 0) (the pool-rate-residual
    forward's conv) against its plain version, within ``blockn_bound``'s
    bound at mul = 1 and add = 0: u·(4·K·(S + |b|) + 4·|ref|)."""
    x, (w, b, *_) = blockn_inputs(seed, B, T, cin, cout)
    zero = torch.zeros(cout, device=DEVICE)
    one = torch.ones(cout, device=DEVICE)
    out = conv_blockn_rows(x, w, b, one, zero, 1, torch.float32)
    ref = conv_blockn_rows_reference(x, w, b, one, zero, 1, torch.float32)
    torch.cuda.synchronize()
    if out.shape != (B, T, cout) or bool((ref < 0).any()):
        raise AssertionError(f"conv_blockn_rows: {tuple(out.shape)}, or a negative relu")
    k = w.shape[0]
    S = conv_blockn_rows_reference(x.abs(), w.abs(), zero, one, zero, 1, torch.float32)
    bnd = F32_UNIT_ROUNDOFF * (B8_TERM_ULPS * k * cin * (S + b.abs())
                               + B8_EPILOGUE_ULPS * ref.abs())
    diff = (out - ref).abs()
    ratio = float((diff / bnd.clamp(min=1e-30)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"conv_blockn_rows {(B, T, cin, cout)}: {ratio} of its bound")
    return {"kernel": "conv_blockn", "rows": "(b, 1, 0)", "pool": 1, "out_dtype": "float32",
            "shape": [B, T, cin, cout], "max_abs_err": float(diff.max()),
            "err_over_bound": ratio,
            "tolerance": f"|err| <= u*({B8_TERM_ULPS}*K*(S+|b|) + {B8_EPILOGUE_ULPS}*|ref|), "
                         f"u = 2^-24, S = sum|x*w|"}


def check_a2_kernels() -> tuple[list, dict]:
    """The int8 and the pool-rate-residual forwards' kernels: B3's train
    epilogue at config #1's three blocks (CHECK_ROWS rows, bf16 out; the
    train step's batch in f32), config #3's seven dilated and pool-1 blocks
    and QTRAIN_EDGES; B7's index mode at the three train block shapes (and
    with an f32 activation and a bf16 selection) and at ROUTING_EDGES; B8
    with its rows at the three train block shapes. The largest errors."""
    main = []  # the main shapes' checks, whose errors the kernels line reports
    for i, (T, cin, cout, _) in enumerate(QBLOCKS):
        main.append(check_qtrain(qtrain_inputs(400 + i, CHECK_ROWS, T, cin, cout)))
        main.append(check_qtrain(qtrain_inputs(410 + i, TRAIN_BATCH, T, cin, cout),
                                 out_dtype=torch.float32))
        torch.cuda.empty_cache()
    checks = list(main)
    for i, (T, cin, cout, _, d, _) in enumerate(DILATED_BLOCKS):
        checks.append(check_qtrain(qtrain_inputs(420 + i, CHECK_ROWS, T, cin, cout), d))
        torch.cuda.empty_cache()
    for B, T, cin, cout, d, dt in QTRAIN_EDGES:
        checks.append(check_qtrain(qtrain_inputs(B + T + d, B, T, cin, cout), d, dt))
    for i, (c, T) in enumerate(TRAIN_BLOCKS):
        ch = check_routing_idx(430 + i, TRAIN_BATCH, c, T, 2, torch.bfloat16)
        main += ch
        checks += ch + check_routing_idx(440 + i, TRAIN_BATCH, c, T, 2, torch.float32,
                                         sel_dt=torch.bfloat16)
    for B, c, T, pool, dt, rows in ROUTING_EDGES:
        checks += check_routing_idx(B + c + T + 1, B, c, T, pool, dt, rows)
    cin = TRAIN_C0
    for i, (c, T) in enumerate(TRAIN_BLOCKS):
        checks.append(check_blockn_rows(450 + i, TRAIN_BATCH, T, cin, c))
        cin = c
    errors = {k: max(c["max_abs_err"] for c in main if c["kernel"] == k)
              for k in ("quant_block_train", "pool_fwd_idx", "route_bwd_idx")}
    return checks, errors


def check_train_kernels(store, idx, offsets) -> dict:
    """B4/B5 on the tensor cores at the train step's shape and at
    B45_EDGES, B5 at the train step's own inputs on its own routes
    (check_b5_step), their f32 route at B45_F32_EDGE, B45_F32_WIDE and
    B45_F32_ROWS; B7 at
    the three block shapes
    of the train step and at ROUTING_EDGES, bf16 and f32; the int8 and the
    pool-rate-residual forwards' kernels (``check_a2_kernels``); the
    BatchNorm epilogue pair at the four pool-rate shapes, at the train step's
    batch and the large one (``check_bn_epilogue``); the launch counters read
    around the phase (B4's and B5's f32 route runs only here)."""
    reset_counts()
    x = gather_whiten(store, idx[:TRAIN_BATCH], offsets[:TRAIN_BATCH], FRAG)[..., None]
    checks, errors = check_block0_train(x, block0_train_inputs(10, TRAIN_BATCH, FRAG, TRAIN_C0))
    del x
    for B, T, c, rows in B45_EDGES:
        xe, *params = b45_edge_inputs(B + T + c, B, T, c, rows)
        checks += check_block0_train(xe, tuple(params), rows)[0]
    step_cases, err = check_b5_step(B5_STEP_SEED)
    checks += step_cases
    errors["conv_block0_train_bwd"] = max(errors["conv_block0_train_bwd"],
                                          err["conv_block0_train_bwd"])
    f32_cases = [(*B45_F32_EDGE, "plain"), (*B45_F32_WIDE, "plain"), *B45_F32_ROWS]
    for i, (B, T, c, rows) in enumerate(f32_cases):
        xe, *params = b45_edge_inputs(11 + i, B, T, c, rows)
        ch, err = check_block0_train_f32(xe, tuple(params), rows)
        checks += ch
        for k, v in err.items():
            errors[k] = max(errors.get(k, 0.0), v)
        del xe, params
    for i, (c, T) in enumerate(TRAIN_BLOCKS):
        ch, err = check_routing(20 + i, TRAIN_BATCH, c, T, 2, torch.bfloat16)
        checks += ch
        for k, v in err.items():
            errors[k] = max(errors.get(k, 0.0), v)
    for B, c, T, pool, dt, rows in ROUTING_EDGES:
        checks += check_routing(B + c + T, B, c, T, pool, dt, rows)[0]
    a2_checks, a2_errors = check_a2_kernels()
    checks += a2_checks
    errors.update(a2_errors)
    epilogue = check_bn_epilogue(TRAIN_BATCH) + check_bn_epilogue(TRAIN_TIMING_BATCHES[-1])
    checks += epilogue
    for name in ("bn_apply", "bn_grad"):
        errors[name] = max(ch["max_abs_err"] for ch in epilogue if ch["kernel"] == name)
    launches = read_counts()
    emit({"phase": "train_kernels", "checks": checks, "launches": launches})
    return {"errors": errors, "launches": launches}


@contextlib.contextmanager
def evaluation_launches():
    """Count the kernel launches made inside ``nshot.evaluate`` apart."""
    counts = {name: 0 for name in KERNELS}
    real = nshot.evaluate

    def counted(*args, **kw):
        before = read_counts()
        out = real(*args, **kw)
        after = read_counts()
        for name in counts:
            counts[name] += after[name] - before[name]
        return out

    nshot.evaluate = counted
    try:
        yield counts
    finally:
        nshot.evaluate = real


@contextlib.contextmanager
def plain_kernels(keep: tuple = ()):
    """The train path with every train kernel (B4, B5, B7, B3's train
    epilogue, B8 with its rows, the BN pair, ``conv_wgrad``) and B6, which
    config #4's forward runs, replaced by its plain version; the wrappers
    named in ``keep`` stay."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in PLAIN]
    for mod, name, plain in PLAIN:
        if name not in keep:
            setattr(mod, name, plain)
    try:
        with plain_log_mel():
            yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def held_steps(model, cfg, run, hold: bool = True, only: tuple = None) -> dict:
    """``run(state) → metrics`` once through the kernels and once through
    their plain versions, from the same weights, held by ``compare_steps``;
    with ``only`` (wrapper names of PLAIN), the first run keeps just those
    kernels and every other one plain. With ``hold=False`` the numbers are
    reported and not held."""
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for plain in (False, True):
        model.load_state_dict(snapshot)
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        with (plain_kernels() if plain else contextlib.nullcontext() if only is None
              else plain_kernels(only)):
            loss = float(run(state)["loss"])
        runs.append((loss, step_grads(model)))
    return compare_steps(runs, hold, ("kernels", "plain"))


def step_grads(model) -> dict:
    return {k: p.grad.detach().double().flatten().clone()
            for k, p in model.named_parameters() if p.grad is not None}


def compare_steps(runs: list, hold: bool, names: tuple) -> dict:
    """Two steps' ``(loss, gradients)`` from the same weights: the loss to
    STEP_LOSS_RTOL, every parameter's gradient to a cosine of
    STEP_MIN_COSINE. A parameter the loss does not reach has no gradient in
    either; one whose gradient is zero but for rounding in both
    (STEP_ZERO_GRAD of the largest gradient's norm) is listed apart: a
    siamese loss sees only e1 − e2, so the last block's BatchNorm bias and
    the embedding bias cancel out of it."""
    (loss_k, grads_k), (loss_p, grads_p) = runs
    a, b = names
    if set(grads_k) != set(grads_p):
        raise AssertionError(f"{a} and {b} steps reach other parameters: "
                             f"{sorted(set(grads_k) ^ set(grads_p))}")
    norms = {k: (float(grads_k[k].norm()), float(grads_p[k].norm())) for k in grads_k}
    tiny = STEP_ZERO_GRAD * max(max(n) for n in norms.values())
    zero = sorted(k for k, n in norms.items() if max(n) <= tiny)
    cos = {k: float(torch.nn.functional.cosine_similarity(grads_k[k], grads_p[k], dim=0))
           for k in grads_k if k not in zero}
    worst = min(cos, key=cos.get)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if hold and not (rel <= STEP_LOSS_RTOL and cos[worst] >= STEP_MIN_COSINE):
        raise AssertionError(f"{a} step against {b} step: loss {loss_k} vs {loss_p}, "
                             f"min cosine {cos[worst]} at {worst}")
    return {"held": hold, f"loss_{a}": loss_k, f"loss_{b}": loss_p, "loss_rel_diff": rel,
            "loss_rtol": STEP_LOSS_RTOL, "min_grad_cosine": cos[worst], "min_at": worst,
            "cosine_tolerance": STEP_MIN_COSINE, "params_with_grad": len(grads_k),
            "zero_grad": zero, "zero_grad_tolerance": STEP_ZERO_GRAD}


def classifier_step(cfg, host, store, seed: int, loss_fn_of=None):
    """``(model, run)``: config ``cfg``'s classifier with the seed's random
    weights and ``run(state)``, one train step on a fixed batch drawn from
    ``store`` with fixed dropout, both from ``seed``, through the loss of
    ``loss_fn_of(model, cfg)`` (``steps.classifier_loss_fn`` by default)."""
    n = len(host.label_names)
    model = SpeakerClassifier(cfg.encoder, n, device=DEVICE)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n, seed), cfg.encoder))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], TRAIN_BATCH, DEVICE)
    x, y = fetch_batch(store, idx, cfg, gen), store.labels[idx]
    loss_fn = (loss_fn_of or steps.classifier_loss_fn)(model, cfg)

    def run(state):
        drop = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        return steps.train_on_batch(state, x, y, drop, loss_fn)[1]

    return model, run


def compare_plain_step(cfg, host, store, seed: int) -> dict:
    """One classifier train step from fixed weights and a fixed batch,
    through the kernels and through their plain versions (``held_steps``)."""
    model, run = classifier_step(cfg, host, store, seed)
    return held_steps(model, cfg, run)


def pool_rate_shapes(cfg, batch: int) -> tuple[set, set]:
    """Each block's pool-rate output shape on the fused train forward (block
    0's ``(B, T', C)``, blocks 1+'s ``(B, C, T')``) and the shapes of a
    per-channel vector."""
    enc, T = cfg.encoder, cfg.data.model_length
    shapes, vectors = set(), set()
    for i, (mult, pool) in enumerate(zip(enc.filter_multipliers, enc.pool_sizes)):
        c = enc.filters * mult
        T //= max(pool, 1)
        shapes.add((batch, T, c) if i == 0 else (batch, c, T))
        vectors.update({(c,), (c, 1)})
    return shapes, vectors


def chain_ops(events, shapes: set, vectors: set) -> list:
    """The profiler's ops that belong to the eager pool-rate chain, each
    ``"name [input shapes] under [parents]"``. The head's global max reads
    block 3's output too: its gradient's casts are not the chain's."""
    found = []
    for e in events:
        ins = [tuple(s) for s in e.input_shapes]
        if not any(s in shapes for s in ins) or not (
                e.name in CHAIN_ANY or e.name in CHAIN_WITH_VECTOR
                and any(s in vectors for s in ins)):
            continue
        parents, p = [], e.cpu_parent
        while p is not None:
            parents.append(p.name)
            p = p.cpu_parent
        if not any(name.startswith("AmaxBackward") for name in parents):
            found.append(f"{e.name} {ins[:3]} under {parents[:2]}")
    return found


def check_epilogue_step(cfg, host, store, seed: int) -> dict:
    """One ``compare_plain_step`` step through the kernels and through the
    plain versions, each under the profiler (host ops and their shapes):
    the kernel step launches ``bn_apply`` and ``bn_grad`` once a block, and
    on the card runs no op of the eager chain they replaced on a pool-rate
    tensor; the plain step, which runs that chain, shows that the count sees
    it."""
    model, run = classifier_step(cfg, host, store, seed)
    shapes, vectors = pool_rate_shapes(cfg, TRAIN_BATCH)
    out = {}
    for plain in (False, True):
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        before = (bn_apply.launches, bn_grad.launches)
        with (plain_kernels() if plain else contextlib.nullcontext()), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
            run(state)
        found = chain_ops(prof.events(), shapes, vectors)
        out["plain" if plain else "kernels"] = {
            "bn_apply": bn_apply.launches - before[0], "bn_grad": bn_grad.launches - before[1],
            "chain_ops": len(found), **({} if plain else {"chain_op_list": found[:8]})}
    n = len(cfg.encoder.filter_multipliers)
    got = out["kernels"]
    # On the CPU the wrappers run the plain versions, that is, the chain.
    gone = got["chain_ops"] == 0 or torch.device(DEVICE).type != "cuda"
    if (got["bn_apply"], got["bn_grad"]) != (n, n) or not gone or not out["plain"]["chain_ops"]:
        raise AssertionError(f"the fused step's epilogue: {out}; want bn_apply and bn_grad "
                             f"{n} each, no op of the eager chain, and the plain step's seen")
    return out


def check_channels_last_path(copies: int) -> None:
    """The fused blocks' backward found every cotangent channels last, as
    the train forward lays them out: none was copied into that layout."""
    if copies:
        raise AssertionError(f"{copies} fused-block backward calls took their cotangent in "
                             f"another layout than channels last and copied it")


def train_config(seed: int, base=None):
    """``base`` (config #1 by default) at full width as the train slice runs
    it: batch 32, TRAIN_STEPS steps, one evaluation of 500 tasks at the end."""
    base = base or classifier_baseline()
    return base.replace(train=dataclasses.replace(
        base.train, batch_size=TRAIN_BATCH, num_steps=TRAIN_STEPS, evaluate_every=TRAIN_STEPS,
        num_eval_tasks=500, seed=seed))


def run_train_slice(sliced: dict, seed: int, base=None, phase: str = "train_slice") -> dict:
    """``fit`` at full width of ``base`` (config #1 by default), TRAIN_STEPS
    steps at batch 32, then one n-shot evaluation; the train launches are
    the counts read around ``fit`` less the evaluation's own: per step B1,
    B4 and B5 once, B7's two passes once a block 1+. Then one step against
    its plain-version step: config #1's in bf16, held; any other config's
    held in f32 compute and reported in bf16 (``held_bf16_f32_steps``)."""
    host = sliced["host"]
    cfg = train_config(seed, base)
    n_mid = len(cfg.encoder.filter_multipliers) - 1
    losses, accs = [], []

    def on_step(i, m):
        losses.append(m["loss"])
        accs.append(m["accuracy"])

    copies = FusedBlocknTrain.cotangent_copies
    reset_counts()
    with evaluation_launches() as eval_counts:
        t0 = time.perf_counter()
        state, history = fit(cfg, host, device=DEVICE, verbose=False, on_step=on_step)
        total = read_counts()
        seconds = time.perf_counter() - t0
    train = {k: total[k] - eval_counts[k] for k in total}
    check_channels_last_path(FusedBlocknTrain.cotangent_copies - copies)
    S = TRAIN_STEPS
    n_wgrad = len(wgrad_blocks(cfg))
    want = {name: 0 for name in KERNELS}
    want.update(gather_whiten=S, conv_block0_train=S, conv_block0_train_bwd=S,
                pool_fwd=n_mid * S, route_bwd=n_mid * S, conv_wgrad=n_wgrad * S)
    want = with_epilogue(want)
    if train != want:
        raise AssertionError(f"train launches {train}, want {want} (per step: B1 1, B4 1, "
                             f"B5 1, B7 {n_mid} + {n_mid}, bn_apply and bn_grad "
                             f"{n_mid + 1} each, conv_wgrad {n_wgrad})")
    # As the reference's fit, the evaluation embeds through the model's own
    # forward: B1 for the fragments, then cuDNN; neither B2 nor B8.
    want_eval = {name: 0 for name in KERNELS}
    want_eval["gather_whiten"] = -(-len(host.labels) // 256)
    if eval_counts != want_eval:
        raise AssertionError(f"evaluation launches {eval_counts}, want {want_eval}")
    loss = torch.stack(losses).float().cpu()
    acc = torch.stack(accs).float().cpu()
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"non-finite train loss: {loss.tolist()}")
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    if not last < first:
        raise AssertionError(f"train loss did not fall: first 5 {first}, last 5 {last}")
    val_acc = history[-1]["val_1-shot_acc"]
    if not (bool(((acc >= 0) & (acc <= 1)).all()) and 0.0 <= val_acc <= 1.0):
        raise AssertionError(f"accuracy outside [0, 1]: {acc.tolist()}, val {val_acc}")
    store = device_store_for(cfg, host, DEVICE)
    held = ({"plain_step": compare_plain_step(cfg, host, store, seed),
             "epilogue_step": check_epilogue_step(cfg, host, store, seed)} if base is None else
            {"plain_steps": held_bf16_f32_steps(cfg, host, store, seed)})
    emit({"phase": phase, "config": cfg.name, "dtype": "bfloat16",
          "batch": TRAIN_BATCH, "steps": S, "speakers": len(host.label_names),
          "launches": train, "eval_launches": eval_counts,
          "loss_first5_mean": first, "loss_last5_mean": last, "losses": loss.tolist(),
          "final_record": history[-1], "seconds": seconds, **held})
    return {"launches": train, "cfg": cfg, "store": store, "host": host}


def held_bf16_f32_steps(cfg, host, store, seed: int, loss_fn_of=None,
                        hold: tuple = ("float32",), only: tuple = None) -> dict:
    """One classifier step of ``cfg`` through the kernels (``only`` those,
    where given) and through their plain versions (``held_steps``), held in
    the compute dtypes ``hold`` (f32 by default) and reported in the others,
    as config #2's steps are: in bf16 the kernels' f32 statistics, summed in
    another order, flip a bf16 rounding of BatchNorm's affine now and then
    and the later blocks carry it on; in f32 only the kernels' own
    summation order is left."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, compute_dtype=dtype))
        model, run = classifier_step(dcfg, host, store, seed, loss_fn_of)
        out[dtype] = held_steps(model, dcfg, run, hold=dtype in hold, only=only)
    return out


def recompute_loss_fn(model, cfg):
    """``steps.classifier_loss_fn`` with blocks 1+ through the
    pool-rate-residual op: ``classifier_train_forward(blockn=
    "fused_recompute")``, which no config resolves to (as in the JAX
    package)."""
    fused0 = steps.resolve_fused_block0(cfg, model)

    def loss_fn(x, y, generator):
        model.train()
        logits = fused_train.classifier_train_forward(model, x, generator, "fused_recompute",
                                                      fused0)
        return (train_losses.softmax_ce(logits, y),
                train_losses.categorical_accuracy(logits, y))

    loss_fn.fused_block0, loss_fn.blockn = fused0, "fused_recompute"
    return loss_fn


def step_with(loss_fn, cfg, batch: int):
    """``step(state, store, generator)``: ``steps.make_classifier_train_step``'s
    step (sample, fetch, update) with ``loss_fn``."""
    def step(state, store, generator):
        idx = sampling.sample_classifier_batch(generator, store.labels.shape[0], batch,
                                               store.audio.device)
        x = fetch_batch(store, idx, cfg, generator, stochastic=cfg.data.stochastic)
        return steps.train_on_batch(state, x, store.labels[idx], generator, loss_fn)

    return step


def per_step(steps_run: int, **counts) -> dict:
    """Launches of ``steps_run`` steps of ``counts`` each."""
    return {k: v * steps_run for k, v in counts.items()}


def run_int8_train_slice(sliced: dict, seed: int) -> dict:
    """``fit`` at full config #1 width with ``quant_forward="int8"``
    (``fused_int8``), TRAIN_STEPS steps at batch 32, one evaluation at the
    end: per step B1 1, B4 1, B5 1, B3's train epilogue 3, B7 3 + 3; the
    evaluation on the model's own forward (B1 only); losses finite and
    falling. Then one step from fixed weights and a fixed batch: through
    every kernel against every plain version, reported in f32 and bf16
    (not held: the in-step quantizer turns B4's order-level differences
    into flipped int8 levels, PERF.md §6); through the
    kernels the int8 path adds or feeds anew, each alone (B3's train
    epilogue; B7 on the dequantized activation), the rest plain, held in
    f32 and bf16."""
    host = sliced["host"]
    base = train_config(seed)
    cfg = base.replace(train=dataclasses.replace(base.train, quant_forward="int8"))
    n_mid = len(cfg.encoder.filter_multipliers) - 1
    copies = FusedBlocknTrain.cotangent_copies
    history, losses, train, evals, seconds = counted_fit(cfg, host)
    check_channels_last_path(FusedBlocknTrain.cotangent_copies - copies)
    expect_launches("int8_train_slice", train,
                    **per_step(TRAIN_STEPS, gather_whiten=1, conv_block0_train=1,
                               conv_block0_train_bwd=1, quant_block_train=n_mid,
                               pool_fwd=n_mid, route_bwd=n_mid))
    expect_launches("int8_train_slice evaluation", evals,
                    gather_whiten=-(-len(host.labels) // 256))
    first, last = losses_falling("int8_train_slice", losses)
    store = device_store_for(cfg, host, DEVICE)
    emit({"phase": "int8_train_slice", "config": cfg.name, "blockn": "fused_int8",
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
          "launches": train, "eval_launches": evals, "loss_first5_mean": first,
          "loss_last5_mean": last, "losses": [float(v) for v in losses],
          "final_record": history[-1], "seconds": seconds,
          "plain_steps": held_bf16_f32_steps(cfg, host, store, seed, hold=()),
          "kernel_steps": {name: held_bf16_f32_steps(cfg, host, store, seed,
                                                     hold=("float32", "bfloat16"), only=only)
                           for name, only in (("quant_block_train", ("quant_block_train",)),
                                              ("b7", ("pool_fwd", "route_bwd")))}})
    return {"launches": train}


def run_recompute_train_slice(sliced: dict, seed: int) -> dict:
    """TRAIN_STEPS steps at batch 32 at full config #1 width through
    ``classifier_train_forward(blockn="fused_recompute")`` (``step_with``)
    with the port's clipped Adam, each step's generator seeded as ``fit``
    seeds it: per step B1 1, B4 1, B5 1, B8 3 (pool 1, f32 out, rows (b, 1,
    0)), B7's index mode 3 + 3; losses finite and falling; one step against
    its plain-version step, held in f32 and bf16 (as config #1's fused
    step)."""
    host = sliced["host"]
    cfg = train_config(seed)
    n_mid = len(cfg.encoder.filter_multipliers) - 1
    model = init_model(cfg, len(host.label_names), DEVICE, seed)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    store = device_store_for(cfg, host, DEVICE)
    step = step_with(recompute_loss_fn(model, cfg), cfg, TRAIN_BATCH)
    copies = FusedBlocknTrain.cotangent_copies
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        gen = torch.Generator(device=DEVICE).manual_seed(seed * 1000003 + i)
        state, m = step(state, store, gen)
        losses.append(m["loss"])
    train = read_counts()
    seconds = time.perf_counter() - t0
    check_channels_last_path(FusedBlocknTrain.cotangent_copies - copies)
    expect_launches("recompute_train_slice", train,
                    **per_step(TRAIN_STEPS, gather_whiten=1, conv_block0_train=1,
                               conv_block0_train_bwd=1, conv_blockn=n_mid,
                               pool_fwd_idx=n_mid, route_bwd_idx=n_mid))
    first, last = losses_falling("recompute_train_slice", losses)
    emit({"phase": "recompute_train_slice", "config": cfg.name, "blockn": "fused_recompute",
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
          "launches": train, "loss_first5_mean": first, "loss_last5_mean": last,
          "losses": [float(v) for v in losses], "seconds": seconds,
          "plain_steps": held_bf16_f32_steps(cfg, host, store, seed, recompute_loss_fn,
                                             hold=("float32", "bfloat16"))})
    return {"launches": train}


def run_raw_store_slice(sliced: dict, seed: int) -> dict:
    """``use_pallas_preprocess=False`` at full config #1 width: ``fit`` for
    RAW_STEPS steps on the raw store (per step B4 1, B5 1, B7 3 + 3, B1 0;
    the evaluation B1 0 too), losses finite; the raw chain's batch on the
    card against the same chain on the CPU on the same offsets (one CPU
    generator draws them for both), to RAW_CHAIN_ATOL; at offset 0
    (``stochastic=False``) the raw store's batch against the decimated
    store's B1 batch, within B1's tolerance: PARITY.md's equality at offset
    0, held."""
    host = sliced["host"]
    base = train_config(seed)
    cfg = base.replace(train=dataclasses.replace(
        base.train, use_pallas_preprocess=False, num_steps=RAW_STEPS,
        evaluate_every=RAW_STEPS))
    n_mid = len(cfg.encoder.filter_multipliers) - 1
    history, losses, train, evals, seconds = counted_fit(cfg, host)
    expect_launches("raw_store_slice", train,
                    **per_step(RAW_STEPS, conv_block0_train=1, conv_block0_train_bwd=1,
                               pool_fwd=n_mid, route_bwd=n_mid))
    expect_launches("raw_store_slice evaluation", evals)
    first, last = losses_falling("raw_store_slice", losses, falling=False)
    raw = device_store_for(cfg, host, DEVICE)
    if raw.downsampling != 0:
        raise AssertionError("use_pallas_preprocess=False built a decimated store")
    raw_cpu = device_store_for(cfg, host, "cpu")
    idx = torch.arange(min(len(host.labels), 256), dtype=torch.int32)
    reset_counts()
    got = fetch_batch(raw, idx, cfg, torch.Generator().manual_seed(seed))
    chain_launches = read_counts()
    want = fetch_batch(raw_cpu, idx, cfg, torch.Generator().manual_seed(seed))
    offsets = preprocess.sample_offsets(raw_cpu.lengths[idx.long()], cfg.data.fragment_length,
                                        torch.Generator().manual_seed(seed))
    chain_err = float((got.cpu() - want).abs().max())
    if chain_launches["gather_whiten"] or not chain_err <= RAW_CHAIN_ATOL:
        raise AssertionError(f"raw chain on the card against the CPU: max abs err {chain_err}, "
                             f"B1 launches {chain_launches['gather_whiten']}")
    decimated = device_store_for(base, host, DEVICE)
    at0_raw = fetch_batch(raw, idx, cfg, stochastic=False)
    at0_b1 = fetch_batch(decimated, idx, base, stochastic=False)
    torch.testing.assert_close(at0_raw, at0_b1, rtol=B1_RTOL, atol=B1_ATOL)
    emit({"phase": "raw_store_slice", "config": cfg.name, "use_pallas_preprocess": False,
          "batch": TRAIN_BATCH, "steps": RAW_STEPS, "launches": train, "eval_launches": evals,
          "loss_first5_mean": first, "loss_last5_mean": last,
          "losses": [float(v) for v in losses], "final_record": history[-1],
          "seconds": seconds, "store": {"rows": raw.audio.shape[0],
                                        "samples": raw.audio.shape[1], "downsampling": 0},
          "chain_vs_cpu": {"rows": int(idx.shape[0]), "max_abs_err": chain_err,
                           "tolerance": RAW_CHAIN_ATOL,
                           "offsets_off_the_decimation_grid": int(
                               (offsets % cfg.data.downsampling != 0).sum())},
          "offset0_raw_vs_b1": {"max_abs_err": float((at0_raw - at0_b1).abs().max()),
                                "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}"}})
    return {"launches": train}


def layout_profile(cfg, n_classes: int, dstore, batch: int, seed: int) -> dict:
    """One ``fused`` train step of ``cfg`` at ``batch`` under the profiler
    (``stage_profile.profile``): cuDNN's NCHW↔NHWC conversion kernels' device
    ms a step (0 where the convs run channels last end to end), the idle
    share, device events and the top kernels."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch,
                                                use_fused_blockn=True))
    model = init_model(cfg, n_classes, DEVICE, seed)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    make = (steps.make_siamese_train_step if cfg.mode == "siamese"
            else steps.make_classifier_train_step)
    step, loss_fn = make(model, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    prof = stage_profile.profile([("step", lambda _: step(state, dstore, gen))])
    return {"config": cfg.name, "batch": batch, "blockn": loss_fn.blockn, **prof}


POLICIES = ("jnp", "fused", "fused_recompute", "fused_int8")  # blocks 1+'s train forwards


def policy_step(base, policy: str, batch: int, n_classes: int, seed: int) -> tuple:
    """``(state, step, loss_fn)``: ``base``'s classifier at ``batch`` with
    blocks 1+ under ``policy`` (``fused_int8`` through
    ``quant_forward="int8"``, ``fused_recompute`` through
    ``recompute_loss_fn``, which no config reaches)."""
    cfg = base.replace(train=dataclasses.replace(
        base.train, batch_size=batch, use_fused_blockn=policy != "jnp",
        quant_forward="int8" if policy == "fused_int8" else "none"))
    model = init_model(cfg, n_classes, DEVICE, seed)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    if policy == "fused_recompute":
        loss_fn = recompute_loss_fn(model, cfg)
        return state, step_with(loss_fn, cfg, batch), loss_fn
    step, loss_fn = steps.make_classifier_train_step(model, cfg)
    if loss_fn.blockn != policy:
        raise AssertionError(f"the {policy} step resolved to {loss_fn.blockn}")
    return state, step, loss_fn


def train_step_turns(base, n_classes: int, dstore, seed: int,
                     policies: tuple = ("jnp", "fused")) -> list:
    """The train step of ``base`` at each batch of TRAIN_TIMING_BATCHES under
    each blocks-1+ policy, in turns (the policies, then the policies
    backwards: jnp, fused, fused, jnp for two): a drift of the card or the
    host over the run weighs on every policy alike."""
    step_rows = []
    for bt in TRAIN_TIMING_BATCHES:
        for blockn in (*policies, *reversed(policies)):
            state, step, loss_fn = policy_step(base, blockn, bt, n_classes, seed)
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            r = time_fn(step, state, dstore, gen, iters=20 if bt <= 256 else 5, warmup=2)
            step_rows.append({"batch": bt, "blockn": blockn, "fused_block0": loss_fn.fused_block0,
                              "step_ms": r["mean_s"] * 1e3, "step_p50_ms": r["p50_s"] * 1e3,
                              "utt_per_s": bt / r["mean_s"],
                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
            del state, step, loss_fn
    return step_rows


def train_step_summary(step_rows: list, policies: tuple = ("jnp", "fused")) -> list:
    """Each (batch, policy)'s mean over its turns."""
    summary = []
    for bt in TRAIN_TIMING_BATCHES:
        for blockn in policies:
            turns = [r for r in step_rows if (r["batch"], r["blockn"]) == (bt, blockn)]
            step_ms = sum(r["step_ms"] for r in turns) / len(turns)
            summary.append({"batch": bt, "blockn": blockn, "step_ms": step_ms,
                            "turns_ms": [r["step_ms"] for r in turns],
                            "utt_per_s": bt / step_ms * 1e3,
                            "peak_mem_gb": max(r["peak_mem_gb"] for r in turns)})
    return summary


def policy_profiles(base, n_classes: int, dstore, seed: int) -> list:
    """One profiled window of the step (``stage_profile.profile``) at each
    batch of TRAIN_TIMING_BATCHES under each of POLICIES: the device's idle
    share and the window's ms a step."""
    rows = []
    for bt in TRAIN_TIMING_BATCHES:
        for policy in POLICIES:
            state, step, _ = policy_step(base, policy, bt, n_classes, seed)
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            prof = stage_profile.profile([("step", lambda _: step(state, dstore, gen))])
            rows.append({"batch": bt, "blockn": policy, "idle_share": prof.get("idle_share"),
                         "window_ms_per_step": prof.get("window_ms_per_batch"),
                         "device_events_per_step": prof.get("device_events_per_batch")})
            del state, step
            torch.cuda.empty_cache()
    return rows


def time_qtrain_blocks(seed: int) -> list:
    """B3's train epilogue at config #1's three blocks and B=BATCH, bf16
    out, beside its bound, its plain version and ``torch._int_mm`` on the
    patch matrix (the GEMM alone)."""
    rows = []
    for i, (T, cin, cout, _) in enumerate(QBLOCKS):
        args = qtrain_inputs(500 + i, BATCH, T, cin, cout)
        qx, qw = args[:2]
        # Bytes: x (int8), w, the rows s and b, a (bf16) written once.
        moved = BATCH * T * cin + 3 * cin * cout + 2 * cout * 4 + BATCH * T * cout * 2
        row = {"T": T, "cin": cin, "cout": cout, "out": "bfloat16",
               **bound(moved, 2.0 * BATCH * T * 3 * cin * cout, INT8_OPS_PER_S)}
        row["ms"] = time_fn(quant_block_train, *args, iters=20)["mean_s"] * 1e3
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_fn(in_chunks(quant_block_train_reference, *args), iters=1,
                                  warmup=1)["mean_s"] * 1e3
        try:  # library yardstick: torch._int_mm on the im2col'd input, GEMM only
            xp = torch.nn.functional.pad(qx, (0, 0, 1, 1))
            a = torch.cat([xp[:, j:j + T] for j in range(3)], dim=-1).reshape(BATCH * T, 3 * cin)
            del xp
            row["library_ms"] = time_fn(torch._int_mm, a, qw.reshape(3 * cin, cout).contiguous(),
                                        iters=10)["mean_s"] * 1e3
            row["library"] = "torch._int_mm on im2col (B*T, 3*Cin) x (3*Cin, Cout), GEMM only"
            del a
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"], row["library"] = None, f"torch._int_mm refused: {e}"
        rows.append(row)
        del args, qx, qw
        torch.cuda.empty_cache()
    return rows


def time_routing_idx(seed: int) -> list:
    """B7's phase-index mode at the train step's three blocks (TRAIN_BATCH)
    as the pool-rate-residual step runs it (forward: an f32 activation into
    a bf16 selection and the index; backward: a bf16 conv output routed by
    the index), queued, beside its bound and its plain version."""
    rows = []
    for i, (cb, tb) in enumerate(TRAIN_BLOCKS):
        za, bias, sg, g, k0, k1, k2 = routing_inputs(60 + i, TRAIN_BATCH, cb, tb, 2,
                                                     torch.float32)
        zero = torch.zeros_like(bias)
        z = za.to(torch.bfloat16)
        ix = pool_fwd(za, zero, sg, 2, torch.bfloat16, want_idx=True)[3]
        full, half = TRAIN_BATCH * cb * tb, TRAIN_BATCH * cb * (tb // 2)
        fwd = (za, zero, sg, 2, torch.bfloat16)
        bwd = (z, bias, ix, g, k0, k1, k2, 2)
        row = {"batch": TRAIN_BATCH, "C": cb, "T": tb,
               "pool_fwd_idx_ms": time_fn(pool_fwd, *fwd, want_idx=True, iters=50,
                                          queued=True)["mean_s"] * 1e3,
               "route_bwd_idx_ms": time_fn(route_bwd, *bwd, iters=50,
                                           queued=True)["mean_s"] * 1e3,
               "pool_fwd_idx_plain_ms": time_fn(pool_fwd_reference, *fwd, want_idx=True,
                                                iters=3, warmup=1)["mean_s"] * 1e3,
               "route_bwd_idx_plain_ms": time_fn(route_bwd_reference, *bwd, iters=3,
                                                 warmup=1)["mean_s"] * 1e3,
               # Bytes: a (f32) in, a_sel (bf16) and idx out, four (C,) rows;
               # z (bf16), idx and g (f32) in, dz (bf16) out, five rows.
               # Operations as B7's value mode: 8 an element forward, 12 backward.
               "pool_fwd_idx_bound": bound(full * 4 + half * 2 + half + 4 * cb * 4, 8.0 * full,
                                           F32_OPS_PER_S),
               "route_bwd_idx_bound": bound(full * 2 + half + half * 4 + full * 2 + 5 * cb * 4,
                                            12.0 * full, F32_OPS_PER_S)}
        rows.append(row)
        del za, z, ix, g
        torch.cuda.empty_cache()
    return rows


def time_bn_epilogue(batches: tuple) -> list:
    """The BatchNorm epilogue pair, queued, at the four pool-rate shapes and
    each of ``batches`` (bf16, a keep mask at EPILOGUE_RATE), beside the
    plain versions (the eager chain the pair replaced) and the bound."""
    keep = 1.0 - EPILOGUE_RATE
    rows = []
    for bt in batches:
        for i, (tp, c) in enumerate(epilogue_shapes()):
            sel, mu, r, scale, beta, gy, mask = epilogue_inputs(70 + i, bt, tp, c)
            fwd = (sel, mu, scale, beta, mask, keep, torch.bfloat16)
            bwd = (gy, sel, mask, keep, mu, r)
            n = bt * tp * c
            iters = 50 if bt == TRAIN_BATCH else 10
            # Bytes: the bf16 a_sel read and y written; the bf16 cotangent and
            # a_sel read and the f32 cotangent written (the mask and the
            # vectors, B·C and C floats, left out). Operations: f32 on the CUDA
            # cores, 5 an element forward (the affine's 3, the dropout's
            # product and select), 8 backward (the product and select, â's 2,
            # the 2 sums' product and 2 adds).
            row = {"batch": bt, "T'": tp, "C": c,
                   "bn_apply_bound": bound(n * 4, 5.0 * n, F32_OPS_PER_S),
                   "bn_grad_bound": bound(n * 8, 8.0 * n, F32_OPS_PER_S)}
            for name, fn, ref, args in (("bn_apply", bn_apply, bn_apply_reference, fwd),
                                        ("bn_grad", bn_grad, bn_grad_reference, bwd)):
                row[f"{name}_ms"] = time_fn(fn, *args, iters=iters,
                                            queued=True)["mean_s"] * 1e3
                row[f"{name}_plain_ms"] = time_fn(ref, *args, iters=3, warmup=1)["mean_s"] * 1e3
                row[f"{name}_bound_share"] = row[f"{name}_bound"]["bound_ms"] / row[f"{name}_ms"]
            rows.append(row)
            del sel, gy, fwd, bwd
            torch.cuda.empty_cache()
    return rows


def run_train_timing(store, idx, offsets, trained: dict, seed: int, card: str) -> dict:
    """B4, B5 and B7 at the train step's shapes beside bounds, plain
    versions and (B5) a library call, B7 per block at B=2048 beside its
    bound; the BatchNorm epilogue pair per pool-rate output at the train
    step's batch and at B=2048 beside its bound and the eager chain; B3's train epilogue per block at B=2048 and B7's index mode per
    block at the train step's batch beside theirs; the ``fused`` step's
    layout conversions at B=2048 (an earlier line); the train step at each
    batch of TRAIN_TIMING_BATCHES under the four blocks-1+ policies, with
    each policy's idle share."""
    B, T, c = TRAIN_BATCH, FRAG, TRAIN_C0
    ms, plain_ms, bounds, library_ms, b45 = {}, {}, {}, {}, []
    f32 = torch.float32
    for bt in TRAIN_TIMING_BATCHES:
        x = gather_whiten(store, idx[:bt], offsets[:bt], FRAG)[..., None]
        w, b, sgn, _, c0, c1, c2 = block0_train_inputs(30, 1, T, c)
        cot = torch.randn(bt, T // 4, c, generator=torch.Generator(device=DEVICE).manual_seed(31),
                          device=DEVICE)
        fwd, bwd = (x, w, b, sgn), (x, w, b, sgn, cot, c0, c1, c2)
        iters = 50 if bt <= 256 else 10
        conv_ops = 2.0 * bt * T * c * 32
        pooled = bt * (T // 4) * c
        # Bytes: x, w, a_sel (bf16; f32 route f32), the statistics; x, w, g in
        # f32, dW and db. Operations: the conv (B5: and the dW product) at the
        # bf16 tensor-core rate; on the f32 route three TF32 products a
        # product (3xTF32) at the TF32 tensor-core rate.
        row = {"batch": bt, "bound": {
            "conv_block0_train": bound(bt * T * 4 + 32 * c * 4 + pooled * 2 + 3 * c * 4,
                                       conv_ops, BF16_OPS_PER_S),
            "conv_block0_train_bwd": bound(bt * T * 4 + 32 * c * 4 + pooled * 4 + 33 * c * 4,
                                           2 * conv_ops, BF16_OPS_PER_S),
            "conv_block0_train_f32": bound(bt * T * 4 + 32 * c * 4 + pooled * 4 + 3 * c * 4,
                                           3 * conv_ops, TF32_OPS_PER_S),
            "conv_block0_train_bwd_f32": bound(bt * T * 4 + 32 * c * 4 + pooled * 4
                                               + 33 * c * 4, 3 * 2 * conv_ops,
                                               TF32_OPS_PER_S)}}
        # queued: the device's time alone (at B=32 a call's host work outlasts
        # it, and back to back the span times the host)
        for name, fn, args in (("conv_block0_train", conv_block0_train, fwd),
                               ("conv_block0_train_bwd", conv_block0_train_bwd, bwd),
                               ("conv_block0_train_f32", conv_block0_train, (*fwd, 4, f32, f32)),
                               ("conv_block0_train_bwd_f32", conv_block0_train_bwd,
                                (*bwd, 4, f32))):
            n = iters if "f32" not in name else max(3, iters // 5)
            row[f"{name}_ms"] = time_fn(fn, *args, iters=n, queued=True)["mean_s"] * 1e3
            row[f"{name}_back_to_back_ms"] = time_fn(fn, *args, iters=n)["mean_s"] * 1e3
            row[f"{name}_bound_share"] = row["bound"][name]["bound_ms"] / row[f"{name}_ms"]
        # Library yardstick for B5: cuDNN's weight gradient of the same conv
        # from a dz already materialized at full rate, the GEMM alone (no
        # recompute, routing, dz or db): less work than B5.
        dz = torch.randn(bt, c, T, device=DEVICE).to(torch.bfloat16)
        xp = torch.nn.functional.pad(x[..., 0].to(torch.bfloat16)[:, None, :], (15, 16))
        row["conv1d_weight_bf16_ms"] = time_fn(torch.nn.grad.conv1d_weight, xp, (c, 1, 32), dz,
                                               iters=iters)["mean_s"] * 1e3
        row["conv1d_weight_f32_ms"] = time_fn(torch.nn.grad.conv1d_weight, xp.float(),
                                              (c, 1, 32), dz.float(),
                                              iters=max(3, iters // 5))["mean_s"] * 1e3
        del dz, xp
        if bt == B:
            for name, ref, args in (("conv_block0_train", conv_block0_train_reference, fwd),
                                    ("conv_block0_train_bwd", conv_block0_train_bwd_reference,
                                     bwd),
                                    ("conv_block0_train_f32", conv_block0_train_reference,
                                     (*fwd, 4, f32, f32)),
                                    ("conv_block0_train_bwd_f32",
                                     conv_block0_train_bwd_reference, (*bwd, 4, f32))):
                plain_ms[name] = time_fn(ref, *args, iters=3, warmup=1)["mean_s"] * 1e3
                ms[name] = row[f"{name}_ms"]
                bounds[name] = row["bound"][name]
            library_ms.update(conv_block0_train=None, conv_block0_train_f32=None,
                              conv_block0_train_bwd=row["conv1d_weight_bf16_ms"],
                              conv_block0_train_bwd_f32=row["conv1d_weight_f32_ms"])
        b45.append(row)
        del x, cot, fwd, bwd
        torch.cuda.empty_cache()
    library_ms.update(pool_fwd=None, route_bwd=None)
    blocks = []
    big = TRAIN_TIMING_BATCHES[-1]
    for bt in (B, big):  # the train step's batch, then B=2048 (kernels and bounds only)
        for i, (cb, tb) in enumerate(TRAIN_BLOCKS):
            z, bias, sg, g, k0, k1, k2 = routing_inputs(40 + i, bt, cb, tb, 2, torch.bfloat16)
            sel = pool_fwd(z, bias, sg, 2)[0]
            full, half = bt * cb * tb, bt * cb * (tb // 2)
            iters = 50 if bt == B else 10
            # queued: the device's time alone; at B=32 a call's host work
            # outlasts it, and back to back the span times the host.
            row = {"batch": bt, "C": cb, "T": tb,
                   "pool_fwd_ms": time_fn(pool_fwd, z, bias, sg, 2, iters=iters,
                                          queued=True)["mean_s"] * 1e3,
                   "route_bwd_ms": time_fn(route_bwd, z, bias, sel, g, k0, k1, k2, 2,
                                           iters=iters, queued=True)["mean_s"] * 1e3,
                   "pool_fwd_back_to_back_ms": time_fn(pool_fwd, z, bias, sg, 2,
                                                       iters=iters)["mean_s"] * 1e3,
                   "route_bwd_back_to_back_ms": time_fn(route_bwd, z, bias, sel, g, k0, k1, k2,
                                                        2, iters=iters)["mean_s"] * 1e3,
                   # Bytes: z, a_sel, and bias, sgn, Σa, Σa² (C each); z, a_sel, g in
                   # f32, dz, and bias, c0, c1, c2, db. Operations: f32 on the CUDA
                   # cores, 8 an element forward (add, round, relu, 2 sums, a square,
                   # the sign, the max), 12 backward.
                   "pool_fwd_bound": bound(full * 2 + half * 2 + 4 * cb * 4, 8.0 * full,
                                           F32_OPS_PER_S),
                   "route_bwd_bound": bound(full * 2 + half * 2 + half * 4 + full * 2
                                            + 5 * cb * 4, 12.0 * full, F32_OPS_PER_S)}
            if bt == B:
                row["pool_fwd_plain_ms"] = time_fn(pool_fwd_reference, z, bias, sg, 2, iters=3,
                                                   warmup=1)["mean_s"] * 1e3
                row["route_bwd_plain_ms"] = time_fn(route_bwd_reference, z, bias, sel, g, k0,
                                                    k1, k2, 2, iters=3,
                                                    warmup=1)["mean_s"] * 1e3
            for name in ("pool_fwd", "route_bwd"):
                row[f"{name}_bound_share"] = row[f"{name}_bound"]["bound_ms"] / row[f"{name}_ms"]
            blocks.append(row)
            del z, sel, g
            torch.cuda.empty_cache()
    at_b = [r for r in blocks if r["batch"] == B]
    for name in ("pool_fwd", "route_bwd"):
        ms[name] = sum(r[f"{name}_ms"] for r in at_b)
        plain_ms[name] = sum(r[f"{name}_plain_ms"] for r in at_b)
        bounds[name] = {"bound_ms": sum(r[f"{name}_bound"]["bound_ms"] for r in at_b),
                        "bound_by": "bytes"}

    epilogue = time_bn_epilogue((B, big))
    for name in ("bn_apply", "bn_grad"):
        at_b = [r for r in epilogue if r["batch"] == B]
        ms[name] = sum(r[f"{name}_ms"] for r in at_b)
        plain_ms[name] = sum(r[f"{name}_plain_ms"] for r in at_b)
        bounds[name] = {"bound_ms": sum(r[f"{name}_bound"]["bound_ms"] for r in at_b),
                        "bound_by": "bytes"}
        library_ms[name] = None

    qtrain = time_qtrain_blocks(seed)
    idx_blocks = time_routing_idx(seed)
    ms["quant_block_train"] = sum(r["ms"] for r in qtrain)
    plain_ms["quant_block_train"] = sum(r["plain_ms"] for r in qtrain)
    bounds["quant_block_train"] = {  # bound_by: the kind that bounds most of the sum
        "bound_ms": sum(r["bound_ms"] for r in qtrain),
        "bound_by": max(("bytes", "operations"), key=lambda kind: sum(
            r["bound_ms"] for r in qtrain if r["bound_by"] == kind))}
    library_ms["quant_block_train"] = (None if any(r["library_ms"] is None for r in qtrain)
                                       else sum(r["library_ms"] for r in qtrain))
    for name in ("pool_fwd_idx", "route_bwd_idx"):
        ms[name] = sum(r[f"{name}_ms"] for r in idx_blocks)
        plain_ms[name] = sum(r[f"{name}_plain_ms"] for r in idx_blocks)
        bounds[name] = {"bound_ms": sum(r[f"{name}_bound"]["bound_ms"] for r in idx_blocks),
                        "bound_by": "bytes"}
        library_ms[name] = None

    host, base = trained["host"], trained["cfg"]
    dstore = trained["store"]
    step_rows = train_step_turns(base, len(host.label_names), dstore, seed, POLICIES)
    torch.cuda.empty_cache()
    emit({"phase": "train_layout", "card": card,
          "fused_step": layout_profile(base, len(host.label_names), dstore, big, seed)})
    summary = train_step_summary(step_rows, POLICIES)
    profiles = policy_profiles(base, len(host.label_names), dstore, seed)
    emit({"phase": "train_timing", "card": card, "kernel_ms": ms, "plain_ms": plain_ms,
          "bound": bounds, "library_ms": library_ms,
          "library": {"conv_block0_train_bwd": "torch.nn.grad.conv1d_weight on a "
                      "materialized bf16 (B, C, T) dz, the weight-gradient GEMM alone: less "
                      "work than B5 (no recompute, routing, dz or db)",
                      "conv_block0_train_bwd_f32": "the same call in f32 (TF32 off)",
                      "quant_block_train": "torch._int_mm on the patch matrix, GEMM only, "
                      "summed over blocks 1-3"},
          "block0_batches": b45, "routing_blocks": blocks, "routing_idx_blocks": idx_blocks,
          "bn_epilogue_blocks": epilogue,
          "quant_block_train_blocks": qtrain, "train_step_turns": step_rows,
          "train_step": summary, "train_step_profiles": profiles})
    return {"ms": ms, "plain_ms": plain_ms, "bounds": bounds, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# config #3 (dilated_4khz): the dilated and pool-1 blocks on B8 and B3
# ---------------------------------------------------------------------------

def time_cudnn_dilated_convs(encoder, batches=None) -> list:
    """cuDNN's convs of each block 1+ as the train step runs them (the fused
    op's NHWC ``conv2d`` on (B, C, 1, T) channels-last views, forward and
    ``convolution_backward`` for dX and dW) beside ``F.conv1d`` in NCT at the
    same dilation, forward and backward, in bf16, at each train batch; and
    the NHWC pair again with cuDNN's autotuner on (``benchmark=True``: each
    algorithm tried once, the fastest kept), which the port does not use."""
    rows = []
    t = FRAG // encoder.cfg.pool_sizes[0]
    for bt in batches or TRAIN_TIMING_BATCHES:
        tb = t
        for i, blk in enumerate(encoder.blocks[1:], start=1):
            cin, cout, k = blk.conv.in_channels, blk.conv.out_channels, blk.conv.kernel_size[0]
            d, pad = blk.conv.dilation[0], blk.conv.dilation[0] * (k - 1) // 2
            g = torch.Generator(device=DEVICE).manual_seed(60 + i)
            x = torch.randn(bt, cin, tb, generator=g, device=DEVICE).to(torch.bfloat16)
            w = (torch.randn(cout, cin, k, generator=g, device=DEVICE) * 0.05).to(torch.bfloat16)
            dz = torch.randn(bt, cout, tb, generator=g, device=DEVICE).to(torch.bfloat16)
            x4 = x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
            w4 = w.unsqueeze(2).contiguous(memory_format=torch.channels_last)
            dz4 = dz.unsqueeze(2).contiguous(memory_format=torch.channels_last)
            conv_bwd = torch.ops.aten.convolution_backward
            iters = 20 if bt <= 256 else 5
            rows.append({
                "batch": bt, "block": i, "cin": cin, "cout": cout, "T": tb, "dilation": d,
                "nhwc_fwd_ms": time_fn(torch.nn.functional.conv2d, x4, w4, None,
                                       padding=(0, pad), dilation=(1, d),
                                       iters=iters)["mean_s"] * 1e3,
                "nhwc_bwd_ms": time_fn(conv_bwd, dz4, x4, w4, None, [1, 1], [0, pad], [1, d],
                                       False, [0, 0], 1, [True, True, False],
                                       iters=iters)["mean_s"] * 1e3,
                "nct_fwd_ms": time_fn(torch.nn.functional.conv1d, x, w, None, padding=pad,
                                      dilation=d, iters=iters)["mean_s"] * 1e3,
                "nct_bwd_ms": time_fn(conv_bwd, dz, x, w, None, [1], [pad], [d], False, [0],
                                      1, [True, True, False], iters=iters)["mean_s"] * 1e3})
            with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                            allow_tf32=False):
                rows[-1].update(
                    nhwc_fwd_autotuned_ms=time_fn(torch.nn.functional.conv2d, x4, w4, None,
                                                  padding=(0, pad), dilation=(1, d),
                                                  iters=iters)["mean_s"] * 1e3,
                    nhwc_bwd_autotuned_ms=time_fn(conv_bwd, dz4, x4, w4, None, [1, 1], [0, pad],
                                                  [1, d], False, [0, 0], 1,
                                                  [True, True, False],
                                                  iters=iters)["mean_s"] * 1e3)
            del x, w, dz, x4, w4, dz4
            if blk.pool_size > 1:
                tb //= blk.pool_size
        torch.cuda.empty_cache()
    return rows


def run_dilated_timing(store, sliced: dict, gate: dict, trained: dict, seed: int,
                       card: str) -> dict:
    """Config #3 at B=BATCH: B8 and B3 per block beside their bounds, plain
    versions and library calls (``F.conv1d`` with the block's dilation; the
    int8 GEMM on the dilated patch matrix); the bf16 and int8 embeds' utt/s,
    batch-1 latency and peak memory; each path's stages; the train step at
    each batch of TRAIN_TIMING_BATCHES under both blocks-1+ policies; cuDNN's
    dilated convs per block, NHWC as the train step runs them beside NCT."""
    model, cfg = sliced["model"], sliced["cfg"]
    enc = model.encoder
    bench, rows = bench_device_store(store)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = fetch_batch(bench, rows, cfg, gen)
    b8 = time_blockn(enc, x)
    e = cfg.encoder
    blocks, t = [], FRAG // e.pool_sizes[0]
    for i in range(1, len(e.filter_multipliers)):
        pool = max(e.pool_sizes[i], 1)
        blocks.append((t, e.filters * e.filter_multipliers[i - 1],
                       e.filters * e.filter_multipliers[i], pool, e.dilations[i],
                       i == len(e.filter_multipliers) - 1))
        t //= pool
    b3 = time_quant_blocks(seed, blocks)["blocks"]
    qvars = gate["qvars"]
    paths = {}
    for path, stages_fn in (("bf16", lambda xf: stage_profile.stages_bf16(enc, xf)),
                            ("int8", lambda xf: stage_profile.stages_int8(enc, qvars, xf))):
        stage_ms, h = {}, x
        with torch.inference_mode():
            for name, fn in stages_fn(lambda: x)[1:]:
                stage_ms[name] = time_fn(fn, h, iters=10)["mean_s"] * 1e3
                h = fn(h)
        del h
        embed = fast_embed if path == "bf16" else (
            lambda encoder, xb: quant_embed(encoder, qvars, xb))

        def serve(indices, embed=embed):
            with torch.inference_mode():
                return embed(enc, fetch_batch(bench, indices, cfg, gen))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tput = throughput(serve, rows, items_per_call=BATCH, iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 1e9
        lat = time_fn(serve, rows[:1], iters=50, warmup=5)
        paths[path] = {"utt_per_s_b2048": tput["items_per_sec"],
                       "ms_b2048": tput["sec_per_call"] * 1e3, "peak_mem_gb": peak,
                       "batch1_p50_ms_events": lat["p50_s"] * 1e3,
                       "batch1_p95_ms_events": lat["p95_s"] * 1e3, "stage_ms": stage_ms}
    del x
    torch.cuda.empty_cache()
    host, tcfg = trained["host"], trained["cfg"]
    step_rows = train_step_turns(tcfg, len(host.label_names), trained["store"], seed)
    convs = time_cudnn_dilated_convs(enc)
    emit({"phase": "dilated_timing", "card": card, "config": cfg.name,
          "conv_blockn": b8, "quant_block": b3, "paths": paths,
          "int8_served": gate["int8_served"], "int8_min_cosine": gate["min_cosine"],
          "train_step_turns": step_rows, "train_step": train_step_summary(step_rows),
          "cudnn_convs": convs})
    return {"conv_blockn": b8, "quant_block": b3}


def wgrad_blocks(cfg=None) -> list:
    """``(block, T, Cin, Cout, dilation)`` of each block 1+ of ``cfg``
    (config #3 by default) whose weight gradient the fused train path takes
    from ``conv_wgrad`` (``conv_train.wgrad_routed``); T at FRAG samples."""
    cfg = cfg or dilated_4khz()
    e = cfg.encoder
    gemm = fused_train._gemm_dtype(getattr(torch, e.compute_dtype))
    out, t = [], FRAG // e.pool_sizes[0]
    for i in range(1, len(e.filter_multipliers)):
        cin, cout = e.filters * e.filter_multipliers[i - 1], e.filters * e.filter_multipliers[i]
        if wgrad_routed(gemm, e.kernel_sizes[i], e.dilations[i], cin, cout):
            out.append((i, t, cin, cout, e.dilations[i]))
        t //= max(e.pool_sizes[i], 1)
    return out


def wgrad_inputs(seed: int, B: int, T: int, cin: int, cout: int) -> tuple:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn(B, T, cin, generator=gen, device=DEVICE).to(torch.bfloat16),
            torch.randn(B, T, cout, generator=gen, device=DEVICE).to(torch.bfloat16))


def check_wgrad() -> tuple[list, float]:
    """``conv_wgrad`` at config #3's dilated blocks at TRAIN_BATCH,
    CHECK_ROWS and BATCH rows (the train slice's, the other checks' and the
    cell's: a split's stages grow with B·T) against float64 sums of the
    same bf16 inputs, added over CHECK_ROWS-row chunks (dW is linear in the
    rows): each dW within TRAIN_REL_TOL of its largest |element| (f32 sums
    in the tensor cores' and the splits' order), a second call equal bit
    for bit → (records, the largest absolute difference)."""
    checks, worst = [], 0.0
    for i, T, cin, cout, d in wgrad_blocks():
        for rows in (TRAIN_BATCH, CHECK_ROWS, BATCH):
            x, dz = wgrad_inputs(90 + i + rows, rows, T, cin, cout)
            got, again = conv_wgrad(x, dz, 3, d), conv_wgrad(x, dz, 3, d)
            want = sum(conv_wgrad_reference(x[lo:lo + CHECK_ROWS].double(),
                                            dz[lo:lo + CHECK_ROWS].double(), 3, d)
                       for lo in range(0, rows, CHECK_ROWS))
            diff = float((got.double() - want).abs().max())
            scale = float(want.abs().max())
            if not (diff <= TRAIN_REL_TOL * scale and torch.equal(got, again)):
                raise AssertionError(f"conv_wgrad at block {i} (d={d}, B={rows}): max |diff| "
                                     f"{diff} of {scale}, repeat equal "
                                     f"{torch.equal(got, again)}")
            checks.append({"kernel": "conv_wgrad", "block": i, "shape": [rows, T, cin, cout],
                           "dilation": d, "max_abs_err": diff, "rel_err_of_max": diff / scale,
                           "tolerance": TRAIN_REL_TOL, "repeat_equal": True})
            worst = max(worst, diff)
            del x, dz, got, again, want
        torch.cuda.empty_cache()
    return checks, worst


def time_wgrad() -> list:
    """``conv_wgrad`` per dilated block at B=BATCH (queued) beside its bound
    (``portbench/counts_wgrad``'s formula), its plain version and cuDNN's
    wgrad alone on the NHWC views the train step hands it."""
    rows = []
    for i, T, cin, cout, d in wgrad_blocks():
        x, dz = wgrad_inputs(95 + i, BATCH, T, cin, cout)
        x4, dz4 = (t.permute(0, 2, 1).unsqueeze(2).contiguous(memory_format=torch.channels_last)
                   for t in (x, dz))
        w4 = torch.zeros(cout, cin, 1, 3, dtype=torch.bfloat16, device=DEVICE).contiguous(
            memory_format=torch.channels_last)
        moved = BATCH * T * (cin + cout) * 2 + 3 * cin * cout * 4
        row = {"block": i, "shape": [BATCH, T, cin, cout], "dilation": d,
               **bound(moved, 2.0 * BATCH * T * 3 * cin * cout, BF16_OPS_PER_S),
               "ms": time_fn(conv_wgrad, x, dz, 3, d, iters=10, queued=True)["mean_s"] * 1e3,
               "plain_ms": time_fn(conv_wgrad_reference, x, dz, 3, d, iters=2,
                                   warmup=1)["mean_s"] * 1e3,
               "library_ms": time_fn(torch.ops.aten.convolution_backward, dz4, x4, w4, None,
                                     [1, 1], [0, d], [1, d], False, [0, 0], 1,
                                     [False, True, False], iters=3, warmup=1)["mean_s"] * 1e3,
               "library": "aten.convolution_backward, output mask [False, True, False], NHWC"}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        del x, dz, x4, dz4
        torch.cuda.empty_cache()
    return rows


def run_wgrad_slice(card: str) -> dict:
    """Phase wgrad_kernels: ``check_wgrad`` (its launches counted) and
    ``time_wgrad``. The kernels line's ``conv_wgrad`` entry is a config #3
    train step's four launches: their ms, plain ms, bounds and cuDNN's ms
    summed."""
    t0 = time.perf_counter()
    reset_counts()
    checks, worst = check_wgrad()
    checked = read_counts()
    rows = time_wgrad()
    emit({"phase": "wgrad_kernels", "card": card, "checks": checks, "launches": checked,
          "timing": rows, "seconds": time.perf_counter() - t0})
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {"errors": {"conv_wgrad": worst}, "launches": {"wgrad_kernels": checked},
            "ms": {"conv_wgrad": total["ms"]}, "plain_ms": {"conv_wgrad": total["plain_ms"]},
            "bounds": {"conv_wgrad": {  # what bounds most of the summed bound
                "bound_ms": total["bound_ms"],
                "bound_by": "operations" if 2 * ops >= total["bound_ms"] else "bytes"}},
            "library_ms": {"conv_wgrad": total["library_ms"]}}


def mel_bench_store(seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bench store undecimated (config #4 runs at downsampling 1), row
    ids, and offsets with the edges: 0, the last valid start, and starts
    that run past the row."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-20000, 20000, size=(BATCH, STORE_T), dtype=np.int16)
    last = STORE_T - MEL_FRAG
    offsets = rng.integers(0, last + 1, BATCH).astype(np.int32)
    offsets[:4] = [0, last, last + 1, STORE_T - 100]
    idx = rng.permutation(BATCH).astype(np.int32)
    return (torch.from_numpy(raw).to(DEVICE), torch.from_numpy(idx).to(DEVICE),
            torch.from_numpy(offsets).to(DEVICE))


@contextlib.contextmanager
def plain_log_mel():
    """The mel paths with B6 replaced by its plain version."""
    real = cuda_melspec.log_mel
    cuda_melspec.log_mel = log_mel_reference
    try:
        yield
    finally:
        cuda_melspec.log_mel = real


def check_log_mel(x: torch.Tensor, cfg: MelConfig, sr: int) -> dict:
    out = log_mel(x, cfg, sr)
    ref = log_mel_reference(x, cfg, sr)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != torch.float32:
        raise AssertionError(f"log_mel {tuple(x.shape)}: {tuple(out.shape)} {out.dtype}, "
                             f"want {tuple(ref.shape)} float32")
    err = float((out - ref).abs().max())
    if not err <= B6_ATOL:
        raise AssertionError(f"log_mel {tuple(x.shape)} {cfg}: max abs err {err} > {B6_ATOL}")
    return {"kernel": "log_mel", "route": cuda_melspec.log_mel_route(cfg, sr),
            "shape": list(x.shape), "out": list(out.shape), "n_fft": cfg.n_fft,
            "hop": cfg.hop_length, "win": cfg.win_length, "n_mels": cfg.n_mels,
            "max_abs_err": err, "tolerance": f"max abs <= {B6_ATOL}"}


def special_rows(x: torch.Tensor) -> torch.Tensor:
    """Four rows: a pure tone (440 Hz at 16 kHz), zeros, and ``x``'s rows
    scaled by 1e3 and 1e-3 (the log floor and a frame's own energy set the
    FFT's error)."""
    t = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    tone = torch.sin(2 * np.pi * 440.0 / 16000.0 * t)
    return torch.stack([tone, torch.zeros_like(tone), x[0] * 1e3, x[1] * 1e-3]).contiguous()


def check_mel_kernels(raw, idx, offsets) -> dict:
    """B1 at frag 48000 over the undecimated store; B6 on 256 of those
    whitened fragments at config #4's geometry (and against the rfft route),
    at MEL_EDGES and on special rows on both routes, the launch counters
    read around the phase (the DFT route runs only here)."""
    t0 = time.perf_counter()
    cfg = melspec_2d()
    sr = cfg.data.sample_rate
    reset_counts()
    got = gather_whiten(raw, idx, offsets, MEL_FRAG)
    want = gather_whiten_reference(raw, idx, offsets, MEL_FRAG)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=B1_RTOL, atol=B1_ATOL)
    errors = {"gather_whiten_48k": float((got - want).abs().max())}
    checks = [{"kernel": "gather_whiten", "shape": list(got.shape),
               "max_abs_err": errors["gather_whiten_48k"],
               "tolerance": f"rtol {B1_RTOL}, atol {B1_ATOL}"}]
    del want
    x = got[:CHECK_ROWS].contiguous()
    del got
    checks.append(check_log_mel(x, cfg.mel, sr))
    errors["log_mel"] = checks[-1]["max_abs_err"]
    rfft = melspec.log_mel_spectrogram(x, cfg.mel, sr)
    checks[-1]["max_abs_err_vs_rfft_route"] = float((log_mel(x, cfg.mel, sr) - rfft).abs().max())
    del rfft
    for B, T, kw in MEL_EDGES:
        checks.append(check_log_mel(x[:B, :T], dataclasses.replace(cfg.mel, **kw), sr))
    rows = special_rows(x)
    for kw in ({}, MEL_DFT):
        checks.append({**check_log_mel(rows, dataclasses.replace(cfg.mel, **kw), sr),
                       "rows": ["tone 440 Hz", "zeros", "x * 1e3", "x * 1e-3"]})
    launches = read_counts()
    want_dft = sum(c["route"] == "dft" for c in checks if c["kernel"] == "log_mel")
    errors["log_mel_dft"] = max(c["max_abs_err"] for c in checks
                                if c["kernel"] == "log_mel" and c["route"] == "dft")
    if launches["log_mel_dft"] != want_dft:
        raise AssertionError(f"mel_kernels: the DFT route ran {launches['log_mel_dft']} times, "
                             f"want {want_dft}")
    emit({"phase": "mel_kernels", "checks": checks, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return {"errors": errors, "launches": launches}


def mel_model(cfg, n_speakers: int, seed: int) -> MelSpecClassifier:
    model = MelSpecClassifier(cfg.encoder, cfg.mel, n_speakers, cfg.data.sample_rate,
                              device=DEVICE)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n_speakers, seed,
                                                          mel=True), cfg.encoder))
    return model


def check_table(name: str, table: torch.Tensor, n_utts: int, d: int, acc: float) -> None:
    if table.shape != (n_utts, d) or table.dtype != torch.float32:
        raise AssertionError(f"{name} table {tuple(table.shape)} {table.dtype}")
    if not bool(torch.isfinite(table).all()):
        raise AssertionError(f"{name} table is not finite")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{name} accuracy {acc} outside [0, 1]")


def run_mel_slices(host, seed: int) -> dict:
    """Config #4 at full width serving the same 500 tasks in bf16 and then in
    int8, each with the launch counters read around its run: B1 and B6 once
    for every embed chunk, nothing else."""
    cfg = melspec_2d()
    n_speakers = host.speaker_counts.shape[0]
    model = mel_model(cfg, n_speakers, seed)
    store = device_store_for(cfg, host, DEVICE)
    n_utts = host.audio.shape[0]
    chunks = -(-n_utts // 256)  # embed_all's batch_size
    want = {name: 0 for name in KERNELS}
    want.update(gather_whiten=chunks, log_mel=chunks)
    d = cfg.encoder.embedding_dim
    out = {"model": model, "cfg": cfg}
    for path in ("mel_bf16", "mel_int8"):
        t0 = time.perf_counter()
        qvars = None
        if path == "mel_int8":
            qvars = quantize_from_store(model, cfg, store, n_cal=256)
            torch.cuda.synchronize()
        calib_seconds = time.perf_counter() - t0
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        reset_counts()
        t0 = time.perf_counter()
        table = nshot.embed_all(model, store, cfg, qvars=qvars)
        acc = nshot.evaluate(model, store, cfg, gen, num_tasks=500, n=1, k=5, qvars=qvars,
                             table=table)
        launches = read_counts()
        seconds = time.perf_counter() - t0
        check_table(path, table, n_utts, d, acc)
        if launches != want:
            raise AssertionError(f"{path} launches {launches}, want {want}")
        # The plain-version path: B1's and B6's plain versions, the same model.
        with torch.inference_mode(), plain_log_mel():
            plain = torch.cat([model.embed(x) if qvars is None
                               else quant_embed_mel(model.encoder, qvars, x)
                               for x in plain_fragments(store, cfg, n_utts)])
        cos_plain = min_cosine(table, plain)
        if cos_plain < TABLE_MIN_COSINE:
            raise AssertionError(f"{path} table vs plain path: min cosine {cos_plain}")
        record = {"phase": path + "_slice", "config": "melspec_2d",
                  "utterances": n_utts, "speakers": n_speakers, "tasks": 500, "n_shot": 1,
                  "k_way": 5, "accuracy": acc, "table_shape": list(table.shape),
                  "launches": launches, "min_cosine_vs_plain": cos_plain,
                  "cosine_tolerance": TABLE_MIN_COSINE, "seconds": seconds}
        if qvars is not None:
            record.update(calibration_rows=min(256, n_utts), calibration_seconds=calib_seconds,
                          min_cosine_int8_vs_bf16_table=min_cosine(table, out["table_bf16"]))
        emit(record)
        out[path] = launches
        out[f"table_{path[4:]}"] = table
    return out


def run_mel_fidelity(raw, offsets, model, seed: int) -> dict:
    """int8 against bf16 on held-out rows: calibrate on bench rows [0, 256),
    embed rows [256, 512) at fresh offsets both ways, min row cosine ≥
    MEL_INT8_MIN_COSINE."""
    t0 = time.perf_counter()
    n_cal = 256
    rng = np.random.default_rng(seed + 2)
    rows = torch.arange(n_cal, dtype=torch.int32, device=DEVICE)
    x_cal = gather_whiten(raw[:n_cal], rows, offsets[:n_cal], MEL_FRAG)[..., None]
    qvars = quantize_mel_encoder(model.encoder, x_cal)
    off = torch.from_numpy(rng.integers(0, STORE_T - MEL_FRAG, n_cal).astype(np.int32)).to(DEVICE)
    x = gather_whiten(raw[n_cal:2 * n_cal], rows, off, MEL_FRAG)[..., None]
    with torch.inference_mode():
        ref = model.embed(x)
        out = quant_embed_mel(model.encoder, qvars, x)
    cos = min_cosine(out, ref)
    emit({"phase": "mel_int8_fidelity", "calibration_rows": [0, n_cal],
          "fidelity_rows": [n_cal, 2 * n_cal], "min_cosine": cos,
          "bound": MEL_INT8_MIN_COSINE, "pass": cos >= MEL_INT8_MIN_COSINE,
          "seconds": time.perf_counter() - t0})
    if not cos >= MEL_INT8_MIN_COSINE:
        raise AssertionError(f"mel int8 vs bf16: min cosine {cos} < {MEL_INT8_MIN_COSINE}")
    return {"qvars": qvars}


def time_log_mel(x: torch.Tensor, mel: MelConfig, sr: int) -> dict:
    """B6 on ``x`` beside its bound (the function's bytes against an rfft's
    operations at the f32 rate), the floors of the DFT-as-matmul algorithm
    at the TF32 and f32 rates and of its 3xTF32 form (three TF32 products a
    product: the DFT route's), its plain version and ``torch.stft``."""
    B, T = x.shape
    work = log_mel_work(B, T, mel, sr)
    row = {"shape": list(x.shape), "n_fft": mel.n_fft, "hop": mel.hop_length,
           "win": mel.win_length, "route": cuda_melspec.log_mel_route(mel, sr),
           **bound(work["bytes"], work["ops"], F32_OPS_PER_S),
           "bytes": work["bytes"], "ops": work["ops"], "dft_ops": work["dft_ops"],
           "dft_tf32_ms": work["dft_ops"] / TF32_OPS_PER_S * 1e3,
           "dft_tf32x3_ms": work["dft_tf32x3_ops"] / TF32_OPS_PER_S * 1e3,
           "dft_f32_ms": work["dft_ops"] / F32_OPS_PER_S * 1e3,
           "ms": time_fn(log_mel, x, mel, sr, iters=10, warmup=2)["mean_s"] * 1e3,
           "plain_ms": time_fn(in_chunks(log_mel_reference, x, mel, sr), iters=2,
                               warmup=1)["mean_s"] * 1e3}
    window = torch.hann_window(mel.win_length, periodic=True, device=x.device)
    row["library_ms"] = time_fn(torch.stft, x, n_fft=mel.n_fft, hop_length=mel.hop_length,
                                win_length=mel.win_length, window=window, center=False,
                                return_complex=True, iters=10, warmup=2)["mean_s"] * 1e3
    row["library"] = "torch.stft (cuFFT), spectrum only: no power, mel or log"
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def run_mel_timing(raw, idx, offsets, model, qvars, seed: int, card: str) -> dict:
    """B6 at B=2048 beside its bounds, plain version and ``torch.stft``, on
    the FFT route (config #4) and the DFT route (MEL_DFT); config #4's embed
    throughput in bf16 and int8, batch-1 latency, peak
    memory of each path."""
    t0 = time.perf_counter()
    cfg = melspec_2d()
    mel, sr = cfg.mel, cfg.data.sample_rate
    x = gather_whiten(raw, idx, offsets, MEL_FRAG)
    row = time_log_mel(x, mel, sr)
    row_dft = time_log_mel(x, dataclasses.replace(mel, **MEL_DFT), sr)
    del x

    rows = torch.arange(BATCH, dtype=torch.int32, device=DEVICE)
    bench = DeviceStore(audio=raw, lengths=torch.full((BATCH,), STORE_T, dtype=torch.int32,
                                                      device=DEVICE),
                        labels=rows, speaker_utts=rows[:, None],
                        speaker_counts=torch.ones_like(rows), downsampling=1)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def serve(indices):
        with torch.inference_mode():
            return model.embed(fetch_batch(bench, indices, cfg, gen))

    def serve_int8(indices):
        with torch.inference_mode():
            return quant_embed_mel(model.encoder, qvars, fetch_batch(bench, indices, cfg, gen))

    paths = {}
    for name, fn in (("bf16", serve), ("int8", serve_int8)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tput = throughput(fn, rows, items_per_call=BATCH, iters=5, warmup=1)
        paths[name] = {"utt_per_s_b2048": tput["items_per_sec"],
                       "ms_b2048": tput["sec_per_call"] * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name, fn in (("bf16", serve), ("int8", serve_int8)):
        lat = time_fn(fn, rows[:1], iters=30, warmup=3)
        paths[name].update(batch1_p50_ms_events=lat["p50_s"] * 1e3,
                           batch1_p95_ms_events=lat["p95_s"] * 1e3)
    emit({"phase": "mel_timing", "card": card, "config": "melspec_2d", "log_mel": row,
          "log_mel_dft": row_dft, "paths": paths, "seconds": time.perf_counter() - t0})
    rows = {"log_mel": row, "log_mel_dft": row_dft}
    return {"ms": {k: r["ms"] for k, r in rows.items()},
            "plain_ms": {k: r["plain_ms"] for k, r in rows.items()},
            "bounds": {k: {b: r[b] for b in ("bound_ms", "bound_by")} for k, r in rows.items()},
            "library_ms": {k: r["library_ms"] for k, r in rows.items()}}


def asp_inputs(seed: int, B: int, T: int, C: int, dtype=torch.bfloat16,
               logits: str = "late") -> tuple:
    """ASP's ``h`` (of both signs, off zero) and logits: ``"unit"`` (a normal
    spread) or ``"late"`` (±60, rising over T, so that the online softmax's
    max keeps moving to later rows and its sums are rescaled again and
    again)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h = (torch.randn(B, T, C, generator=g, device=DEVICE) * 2.0 + 0.5).to(dtype)
    x = torch.randn(B, T, C, generator=g, device=DEVICE)
    if logits == "late":
        ramp = torch.linspace(-60.0, 60.0, T, device=DEVICE)[None, :, None]
        x = (ramp + 60.0 * torch.rand(B, T, C, generator=g, device=DEVICE) - 30.0).clamp(
            -60.0, 60.0)
    return h, x.to(dtype)


def asp_err_over_bound(h: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                       std: torch.Tensor) -> tuple:
    """The largest error of ``mean`` and of ``std²`` over their bounds against
    the float64 statistics of ``h (B, T, C)`` under weights ``w`` (float64,
    summing to 1 over T: the softmax, or 1/T): the mean within (2γ_n +
    u)·Σw|h| and std² within 8γ_n·(Σw·h² + eps), γ_n = n·u / (1 − n·u), u =
    2^-24, n = T + ASP_EXTRA_DEPTH. Each of the kernel's sums holds a term
    through at most T additions, rescales and merges besides the
    exponential's 2 ulps and its product's rounding; the mean is a ratio of
    two such sums, the variance a difference of squares."""
    T = h.shape[1]
    n = T + ASP_EXTRA_DEPTH
    u = F32_UNIT_ROUNDOFF
    gamma = n * u / (1.0 - n * u)
    hd = h.double()
    m64 = (w * hd).sum(1)
    square = (w * hd * hd).sum(1)
    var = (w * (hd - m64[:, None]).square()).sum(1).clamp(min=STAT_EPS)
    r_mean = (mean.double() - m64).abs() / ((2 * gamma + u) * (w * hd.abs()).sum(1))
    r_var = (std.double().square() - var).abs() / (8 * gamma * (square + STAT_EPS))
    return float(r_mean.max()), float(r_var.max())


def check_asp() -> tuple[list, dict]:
    """ASP's two modes at ASP_SHAPE (bf16, logits over ±60 rising in T)
    against the plain versions and float64, in CHECK_ROWS chunks: the kernel
    within ``asp_err_over_bound`` of the float64 statistics (the plain
    versions' own readings beside it), the largest difference from the
    plain version reported, and a second launch equal to the first bit for
    bit."""
    B, T, C = ASP_SHAPE
    h, x = asp_inputs(80, B, T, C)
    pooled, (mean, std) = asp_stats(h, x), asp_stats(h)
    again, (mean2, std2) = asp_stats(h, x), asp_stats(h)
    torch.cuda.synchronize()
    repeats = {"asp_stats": same_bits(pooled, again),
               "asp_global": same_bits(mean, mean2) and same_bits(std, std2)}
    err = {"asp_stats": 0.0, "asp_global": 0.0}
    ratio = {k: (0.0, 0.0) for k in ("asp_stats", "asp_global", "asp_stats_plain",
                                     "asp_global_plain")}
    for lo in range(0, B, CHECK_ROWS):
        rows = slice(lo, lo + CHECK_ROWS)
        hr = h[rows]
        want = attentive_stats_reference(hr, x[rows])
        want_m, want_s = global_stats_reference(hr)
        err["asp_stats"] = max(err["asp_stats"], float((pooled[rows] - want).abs().max()))
        err["asp_global"] = max(err["asp_global"], float((mean[rows] - want_m).abs().max()),
                                float((std[rows] - want_s).abs().max()))
        soft = torch.softmax(x[rows].double(), dim=1)
        flat = torch.full_like(soft, 1.0 / T)
        for name, w, got in (("asp_stats", soft, (pooled[rows, :C], pooled[rows, C:])),
                             ("asp_stats_plain", soft, (want[:, :C], want[:, C:])),
                             ("asp_global", flat, (mean[rows], std[rows])),
                             ("asp_global_plain", flat, (want_m, want_s))):
            ratio[name] = tuple(map(max, ratio[name], asp_err_over_bound(hr, w, *got)))
        del want, want_m, want_s, soft, flat
    checks = []
    for name in ("asp_stats", "asp_global"):
        if not (max(ratio[name]) <= 1.0 and repeats[name]):
            raise AssertionError(f"{name} {ASP_SHAPE}: mean and std² at {ratio[name]} of "
                                 f"their bounds, repeats bit for bit: {repeats[name]}")
        checks.append({"kernel": name, "dtype": "bfloat16", "shape": [B, T, C],
                       "logits": "over ±60, rising in T" if name == "asp_stats" else None,
                       "max_abs_err": err[name], "mean_err_over_bound": ratio[name][0],
                       "var_err_over_bound": ratio[name][1],
                       "plain_err_over_bound": list(ratio[f"{name}_plain"]),
                       "repeats_bit_for_bit": repeats[name],
                       "tolerance": "mean within (2g+u)*sum w|h|, std^2 within "
                                    "8g*(sum w*h^2 + eps) of float64, g = n*u/(1-n*u), "
                                    f"n = T + {ASP_EXTRA_DEPTH}"})
    del h, x
    torch.cuda.empty_cache()
    return checks, err


@contextlib.contextmanager
def plain_asp():
    """ECAPA's forward with ASP's statistics from the plain versions."""
    real = ecapa.asp_stats
    ecapa.asp_stats = lambda h, logits=None: (
        global_stats_reference(h) if logits is None else attentive_stats_reference(h, logits))
    try:
        yield
    finally:
        ecapa.asp_stats = real


def ecapa_embed_path(seed: int) -> dict:
    """``ecapa.fast_embed`` on ASP_EMBED_ROWS seeded 3 s windows at the
    preset's widths (random weights), the launch counters read around it:
    B6 once, B8 once a TDNN, ASP once in each mode; its embeddings against
    the same forward with ASP's plain versions (row cosine)."""
    cfg = ecapa_tdnn()
    model = ecapa.EcapaTDNN(cfg.ecapa, cfg.mel, cfg.data.sample_rate, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = int(cfg.data.seconds * cfg.data.sample_rate)
    x = torch.randn(ASP_EMBED_ROWS, n, 1, generator=g, device=DEVICE) * 0.1
    ecapa.fast_embed(model, x)  # built and warm
    reset_counts()
    emb = ecapa.fast_embed(model, x)
    launches = read_counts()
    tdnns = 3 + (cfg.ecapa.res2net_scale + 1) * (len(cfg.ecapa.channels) - 2)
    expect_launches("ecapa_embed", launches, log_mel=1, log_mel_dft=1, conv_blockn=tdnns,
                    asp_stats=1, asp_global=1)
    with plain_asp():
        want = ecapa.fast_embed(model, x)
    cosine = min_cosine(emb, want)
    if not cosine >= ASP_EMBED_MIN_COSINE:
        raise AssertionError(f"ecapa_embed: min row cosine {cosine} against the plain "
                             f"statistics, want >= {ASP_EMBED_MIN_COSINE}")
    return {"rows": ASP_EMBED_ROWS, "channels": list(cfg.ecapa.channels),
            "launches": launches, "min_cosine_vs_plain_stats": cosine}


def time_asp() -> dict:
    """Both modes at ASP_SHAPE, queued, beside the bound (h, and the logits,
    read once; the statistics written once; f32 operations: 8 an element
    weighted — the subtract, the exponential, the add, two FMAs, the square
    — and 3 unweighted) and the plain versions. No single PyTorch call
    computes either: no library time."""
    B, T, C = ASP_SHAPE
    h, x = asp_inputs(81, B, T, C)
    rows = {}
    for name, args, ref, ops in (("asp_stats", (h, x), attentive_stats_reference, 8.0),
                                 ("asp_global", (h,), global_stats_reference, 3.0)):
        row = {"shape": [B, T, C],
               **bound(asp_stats_bytes(B, T, C, h.element_size(), name == "asp_stats"),
                       ops * B * T * C, F32_OPS_PER_S),
               "ms": time_fn(asp_stats, *args, iters=20, queued=True)["mean_s"] * 1e3,
               "plain_ms": time_fn(ref, *args, iters=3, warmup=1)["mean_s"] * 1e3,
               "library_ms": None, "library": "none: no single PyTorch call computes it"}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
    del h, x
    torch.cuda.empty_cache()
    return rows


def plain_stats64(h: torch.Tensor, x) -> tuple:
    """The plain versions' formula out of place in float64 (so autograd runs
    through it): ``(mean, std)`` of ``h`` under the softmax of ``x`` over T,
    or 1/T."""
    w = torch.softmax(x, dim=1) if x is not None else 1.0 / h.shape[1]
    mean = (w * h).sum(dim=1)
    square = (w * h * h).sum(dim=1)
    return mean, (square - mean * mean).clamp(min=STAT_EPS).sqrt()


def check_asp_backward() -> tuple[list, float]:
    """ASP's backward in both modes at the ECAPA training cell's shape
    (ASP_TRAIN_ROWS × ASP_SHAPE's T and C, bf16, logits over ±60 rising in
    T) through the autograd functions, against float64 autograd through
    the plain versions' formula in ASP_BWD_CHUNK-row chunks: each
    utterance's dh and dlogits within ASP_BWD_RTOL of it (relative to the
    row's norm), the largest absolute difference reported; a second
    backward equal to the first bit for bit. The weighted mode's training
    instantiation: its output equal bit for bit to the inference launch's,
    and the softmax's max and sum it saved for the backward (the autograd
    node's ``softmax``; none on the CPU, whose backward recomputes the
    softmax) against the logits': the max equal, the sum within
    ASP_SUM_GAMMAS·γ_n of float64's (n = T + ASP_EXTRA_DEPTH)."""
    B, T, C = min(ASP_TRAIN_ROWS, ASP_SHAPE[0]), ASP_SHAPE[1], ASP_SHAPE[2]
    h, x = asp_inputs(82, B, T, C)
    g = torch.Generator(device=DEVICE).manual_seed(85)
    gm, gs = (torch.randn(B, C, generator=g, device=DEVICE) for _ in range(2))
    inference = asp_stats(h, x)
    h.requires_grad_()
    x.requires_grad_()
    pooled = asp_stats(h, x)
    saved = pooled.grad_fn.softmax
    grads = {"asp_bwd": torch.autograd.grad(pooled, [h, x], torch.cat([gm, gs], dim=1)),
             "asp_bwd_global": torch.autograd.grad(asp_stats(h), [h], (gm, gs))}
    again = {"asp_bwd": torch.autograd.grad(asp_stats(h, x), [h, x], torch.cat([gm, gs], dim=1)),
             "asp_bwd_global": torch.autograd.grad(asp_stats(h), [h], (gm, gs))}
    torch.cuda.synchronize()
    forward_equal = same_bits(pooled.detach(), inference)
    n = T + ASP_EXTRA_DEPTH
    gamma = n * F32_UNIT_ROUNDOFF / (1.0 - n * F32_UNIT_ROUNDOFF)
    softmax = None
    if saved is not None:
        x32 = x.detach().float()
        mx, total = saved
        sum64 = torch.exp(x32.double() - x32.max(dim=1).values.double()[:, None]).sum(dim=1)
        softmax = {"max_equal": bool(torch.equal(mx, x32.max(dim=1).values)),
                   "sum_err_over_bound": float(((total.double() - sum64).abs()
                                                / (ASP_SUM_GAMMAS * gamma * sum64)).max())}
        del x32, sum64
    rel = {k: 0.0 for k in grads}
    err = 0.0
    for lo in range(0, B, ASP_BWD_CHUNK):
        rows = slice(lo, lo + ASP_BWD_CHUNK)
        h64 = h[rows].detach().double().requires_grad_()
        x64 = x[rows].detach().double().requires_grad_()
        for name, wrt in (("asp_bwd", [h64, x64]), ("asp_bwd_global", [h64])):
            stats = plain_stats64(h64, x64 if name == "asp_bwd" else None)
            want = torch.autograd.grad(stats, wrt, (gm[rows].double(), gs[rows].double()))
            for got, w in zip(grads[name], want):
                d = got[rows].double() - w
                rel[name] = max(rel[name], float((d.flatten(1).norm(dim=1)
                                                  / w.flatten(1).norm(dim=1)).max()))
                err = max(err, float(d.abs().max()))
            del stats, want
        del h64, x64
    checks = []
    for name in grads:
        repeats = all(same_bits(a, b) for a, b in zip(grads[name], again[name]))
        ok = rel[name] <= ASP_BWD_RTOL and repeats
        if name == "asp_bwd":
            ok = ok and forward_equal and (softmax is None or (
                softmax["max_equal"] and softmax["sum_err_over_bound"] <= 1.0))
        if not ok:
            raise AssertionError(f"{name} {[B, T, C]}: row error {rel[name]} (want <= "
                                 f"{ASP_BWD_RTOL}), repeats {repeats}, training forward equal "
                                 f"{forward_equal}, softmax {softmax}")
        checks.append({"kernel": name, "dtype": "bfloat16", "shape": [B, T, C],
                       "max_row_rel_err": rel[name], "repeats_bit_for_bit": repeats,
                       **({"training_forward_bit_for_bit": forward_equal,
                           "saved_softmax": softmax} if name == "asp_bwd" else {}),
                       "tolerance": f"each row within {ASP_BWD_RTOL} of float64 autograd "
                                    "(relative to its norm)"})
    del h, x, pooled, inference, grads, again, saved
    torch.cuda.empty_cache()
    return checks, err


def time_asp_backward() -> dict:
    """ASP's backward in both modes (the autograd functions' backward: one
    kernel pass each) at the ECAPA training cell's shape (ASP_TRAIN_ROWS ×
    ASP_SHAPE's T and C, bf16), queued, beside the bound (h, and the logits,
    read once; dh, and dlogits, written once; the f32 statistics and their
    gradients read once; f32 operations: 12 an element weighted, 4
    unweighted) and the eager autograd it replaced (the backward of the
    plain versions' formula written out of place, its graph kept)."""
    B, T, C = min(ASP_TRAIN_ROWS, ASP_SHAPE[0]), ASP_SHAPE[1], ASP_SHAPE[2]
    h, x = asp_inputs(83, B, T, C)
    g = torch.Generator(device=DEVICE).manual_seed(84)
    gm, gs = (torch.randn(B, C, generator=g, device=DEVICE) for _ in range(2))
    h.requires_grad_()
    x.requires_grad_()

    def plain(weighted):
        w = torch.softmax(x, dim=1, dtype=torch.float32) if weighted else 1.0 / T
        mean = (w * h).sum(dim=1, dtype=torch.float32)
        square = (w * h * h).sum(dim=1, dtype=torch.float32)
        return mean, (square - mean * mean).clamp(min=STAT_EPS).sqrt()

    rows = {}
    for name, weighted, ops in (("asp_bwd", True, 12.0), ("asp_bwd_global", False, 4.0)):
        wrt = [h, x] if weighted else [h]
        out = asp_stats(h, x) if weighted else asp_stats(h)
        grads = torch.cat([gm, gs], dim=1) if weighted else (gm, gs)
        eager = plain(weighted)
        moved = ((4 if weighted else 2) * B * T * C * h.element_size()
                 + (6 if weighted else 4) * B * C * 4)
        row = {"shape": [B, T, C], **bound(moved, ops * B * T * C, F32_OPS_PER_S),
               "ms": time_fn(torch.autograd.grad, out, wrt, grads, retain_graph=True,
                             iters=20, queued=True)["mean_s"] * 1e3,
               "plain_ms": time_fn(torch.autograd.grad, eager, wrt, (gm, gs),
                                   retain_graph=True, iters=3, warmup=1)["mean_s"] * 1e3,
               "library_ms": None, "library": "none: no single PyTorch call computes it"}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        del out, eager
    del h, x
    torch.cuda.empty_cache()
    return rows


def run_asp_slice(seed: int, card: str) -> dict:
    """Phase asp_kernels: ``check_asp`` and ``check_asp_backward`` (their
    launches counted), the ECAPA embed path (``ecapa_embed_path``),
    ``time_asp`` and ``time_asp_backward``. The kernels line's ``asp_bwd``
    entry is a training step's pair: one backward in each mode, their ms,
    plain ms and bounds summed."""
    t0 = time.perf_counter()
    reset_counts()
    checks, errors = check_asp()
    bwd_checks, errors["asp_bwd"] = check_asp_backward()
    checked = read_counts()
    embed = ecapa_embed_path(seed)
    rows = time_asp()
    bwd_rows = time_asp_backward()
    emit({"phase": "asp_kernels", "card": card, "checks": checks + bwd_checks,
          "launches": checked, "ecapa_embed": embed, "timing": rows,
          "backward_timing": bwd_rows, "seconds": time.perf_counter() - t0})
    rows["asp_bwd"] = {k: sum(r[k] for r in bwd_rows.values())
                       for k in ("ms", "plain_ms", "bound_ms")}
    rows["asp_bwd"]["bound_by"] = "bytes"
    return {"errors": errors, "launches": {"asp_kernels": checked,
                                           "ecapa_embed": embed["launches"]},
            "ms": {k: r["ms"] for k, r in rows.items()},
            "plain_ms": {k: r["plain_ms"] for k, r in rows.items()},
            "bounds": {k: {b: r[b] for b in ("bound_ms", "bound_by")} for k, r in rows.items()},
            "library_ms": {k: None for k in rows}}


def ecapa_train_store(rows: int, samples: int, seed: int) -> DeviceStore:
    """``rows`` seeded int16 rows of ``samples`` at downsampling 1, each its
    own speaker, as a DeviceStore."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    audio = torch.randint(-20000, 20000, (rows, samples), generator=g, device=DEVICE,
                          dtype=torch.int16)
    lengths = torch.full((rows,), samples, dtype=torch.int32, device=DEVICE)
    ids = torch.arange(rows, dtype=torch.int32, device=DEVICE)
    return DeviceStore(audio=audio, lengths=lengths, labels=ids, speaker_utts=ids[:, None],
                       speaker_counts=torch.ones_like(ids), downsampling=1)


def run_ecapa_train_slice(seed: int, card: str) -> dict:
    """Phase ecapa_train: ECAPA-TDNN at the preset's widths, its classifier
    over ECAPA_TRAIN_BATCH one-row speakers, ``steps.make_ecapa_train_step``
    at ECAPA_TRAIN_BATCH on a seeded store of 4.5 s rows (3 s windows at
    random offsets): one step built and warm, then one with the launch
    counters set to 0 just before and read just after; the losses finite."""
    t0 = time.perf_counter()
    cfg = ecapa_tdnn()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=ECAPA_TRAIN_BATCH,
                                                seed=seed))
    n = cfg.data.fragment_length
    store = ecapa_train_store(ECAPA_TRAIN_BATCH, n + n // 2, seed)
    model = init_model(cfg, ECAPA_TRAIN_BATCH, DEVICE, seed)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate, cfg.weight_decay)
    step, _ = steps.make_ecapa_train_step(model, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state, first = step(state, store, gen)  # built and warm
    reset_counts()
    state, metrics = step(state, store, gen)
    launches = read_counts()
    expect_launches("ecapa_train", launches, gather_whiten=1, log_mel=1, log_mel_dft=1,
                    asp_stats=1, asp_global=1, asp_bwd=2)
    losses = [float(first["loss"]), float(metrics["loss"])]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ecapa_train: losses {losses}")
    emit({"phase": "ecapa_train", "card": card, "batch": ECAPA_TRAIN_BATCH,
          "channels": list(cfg.ecapa.channels), "losses": losses, "launches": launches,
          "seconds": time.perf_counter() - t0})
    del state, step, model, store
    torch.cuda.empty_cache()
    return {"ecapa_train": launches}


def b9_inputs(seed: int, T: int, nq: int, ns: int, D: int) -> tuple:
    """q (T, nq, D), s (T, ns, D), w (D,) of both signs and b != 0, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(T, nq, D, generator=g, device=DEVICE)
    s = torch.randn(T, ns, D, generator=g, device=DEVICE)
    w = torch.randn(D, generator=g, device=DEVICE)
    return q, s, w, torch.tensor(0.375, device=DEVICE)


def check_siamese_kernels() -> dict:
    """B9 against its plain version at the timing shape, the n-shot form
    and B9_EDGES: equal, to the bit."""
    t0 = time.perf_counter()
    checks = []
    for i, shape in enumerate((B9_TIMING, B9_NSHOT) + B9_EDGES):
        q, s, w, b = b9_inputs(50 + i, *shape)
        c = check_exact("weighted_l1", weighted_l1(q, s, w, b),
                        weighted_l1_reference(q, s, w, b), shape[:3])
        checks.append({**c, "D": shape[3], "form": "row" if shape[1] == 1 else "tile"})
        del q, s
    err = max(c["max_abs_err"] for c in checks)
    if err > B9_MAX_ABS:
        raise AssertionError(f"weighted_l1: max abs err {err} > {B9_MAX_ABS}")
    emit({"phase": "siamese_kernels", "checks": checks, "max_d": MAX_D,
          "seconds": time.perf_counter() - t0})
    return {"errors": {"weighted_l1": err}}


@contextlib.contextmanager
def plain_weighted_l1():
    """The scoring paths with B9 replaced by its plain version."""
    real = cuda_distance.weighted_l1
    cuda_distance.weighted_l1 = weighted_l1_reference
    try:
        yield
    finally:
        cuda_distance.weighted_l1 = real


def b9_scores_held(name: str, fn) -> dict:
    """``fn()`` through B9 and through its plain version: equal scores."""
    with torch.inference_mode():
        got = fn()
        with plain_weighted_l1():
            want = fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        err = float((got - want).abs().max()) if got.shape == want.shape else float("inf")
        raise AssertionError(f"{name}: B9 scores differ from the plain version's "
                             f"(max abs {err})")
    return {"scores": list(got.shape), "max_abs_err": 0.0, "tolerance": "equal"}


def siamese_config():
    return siamese_verification(siamese=SiameseConfig(distance_metric="weighted_l1"))


def run_siamese_slices(host, seed: int) -> dict:
    """Config #2 at full width: the 500 tasks scored by the head in bf16
    and in int8, 1,000 verification pairs and ``score_support`` of the
    table against itself, each with the launch counters read around it."""
    cfg = siamese_config()
    model = SiameseNet(cfg.encoder, cfg.siamese, device=DEVICE)
    variables = random_flax_variables(cfg.encoder, 1, seed)
    variables["params"]["head"]["bias"] = np.array([0.25], np.float32)
    model.load_state_dict(from_flax(variables, cfg.encoder))
    store = device_store_for(cfg, host, DEVICE)
    n_utts = host.audio.shape[0]
    chunks = -(-n_utts // 256)  # embed_all's batch_size
    d = cfg.encoder.embedding_dim
    w, b = nshot.head_params(model)
    out = {"model": model, "cfg": cfg, "store": store}
    for path in ("siamese_bf16", "siamese_int8"):
        t0 = time.perf_counter()
        qvars = None
        if path == "siamese_int8":
            qvars = quantize_from_store(model, cfg, store, n_cal=256)
            torch.cuda.synchronize()
        calib_seconds = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        table = nshot.embed_all(model, store, cfg, fast=qvars is None, qvars=qvars)
        acc = nshot.evaluate(model, store, cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                             num_tasks=500, n=1, k=5, fast=qvars is None, qvars=qvars,
                             table=table)
        launches = read_counts()
        seconds = time.perf_counter() - t0
        check_table(path, table, n_utts, d, acc)
        want = {name: 0 for name in KERNELS}
        want.update(gather_whiten=chunks, conv_block0=chunks, weighted_l1=1)
        if qvars is None:
            want["conv_blockn"] = blockn_launches(model.encoder, n_utts)
        else:
            want["quant_block"] = len(qvars["blocks"]) * chunks
        if launches != want:
            raise AssertionError(f"{path} launches {launches}, want {want}")
        with torch.inference_mode():
            plain = torch.cat([model.embed(x) if qvars is None
                               else quant_embed_plain(model.encoder, qvars, x)
                               for x in plain_fragments(store, cfg, n_utts)])
        cos_plain = min_cosine(table, plain)
        if cos_plain < TABLE_MIN_COSINE:
            raise AssertionError(f"{path} table vs plain path: min cosine {cos_plain}")
        # The tasks evaluate drew, redrawn: B9's scores against the plain
        # version's, and the accuracy they give.
        tasks = sampling.sample_nshot_tasks(torch.Generator(device=DEVICE).manual_seed(seed),
                                            store.speaker_utts, store.speaker_counts, 500, 1, 5)
        q = table[tasks.query_idx.long()]
        s = table[tasks.support_idx.long()].reshape(500, 5, d)
        held = b9_scores_held(path, lambda: dist_ops.head_scores(q, s, w, b, "weighted_l1"))
        with torch.inference_mode():
            pred = nshot.siamese_nshot_predictions(table, tasks.query_idx, tasks.support_idx,
                                                   w, b, "weighted_l1")
        if abs(float((pred == 0).float().mean()) - acc) > 1e-6:
            raise AssertionError(f"{path}: redrawn tasks disagree with evaluate's {acc}")
        record = {"phase": path + "_slice", "config": "siamese_verification",
                  "metric": "weighted_l1", "utterances": n_utts,
                  "speakers": len(host.label_names), "tasks": 500, "n_shot": 1, "k_way": 5,
                  "accuracy": acc, "table_shape": list(table.shape), "launches": launches,
                  "min_cosine_vs_plain": cos_plain, "cosine_tolerance": TABLE_MIN_COSINE,
                  "b9_vs_plain": held, "seconds": seconds}
        if qvars is not None:
            record.update(calibration_rows=min(256, n_utts), calibration_seconds=calib_seconds,
                          min_cosine_int8_vs_bf16_table=min_cosine(table, out["table_bf16"]))
        emit(record)
        out[path] = launches
        out["table_" + path[8:]] = table
        out["accuracy_" + path[8:]] = acc

    table = out["table_bf16"]
    nothing = {name: 0 for name in KERNELS}
    reset_counts()
    t0 = time.perf_counter()
    rep = verification.evaluate_verification(
        model, store, cfg, torch.Generator(device=DEVICE).manual_seed(seed + 1),
        num_pairs=SIAMESE_PAIRS, table=table)
    launches = read_counts()
    seconds = time.perf_counter() - t0
    if launches != {**nothing, "weighted_l1": 1}:
        raise AssertionError(f"verification launches {launches}, want weighted_l1 1")
    if not all(np.isfinite(rep[k]) and 0.0 <= rep[k] <= 1.0 for k in ("eer", "auc")):
        raise AssertionError(f"verification: EER/AUC not finite in [0, 1]: {rep}")
    pairs = sampling.sample_verification_batch(torch.Generator(device=DEVICE).manual_seed(seed + 1),
                                               store.speaker_utts, store.speaker_counts,
                                               SIAMESE_PAIRS, cfg.siamese.same_label)
    held = b9_scores_held("verification", lambda: verification.pair_scores(
        table, pairs.idx_1, pairs.idx_2, cfg, model))
    labels = pairs.labels.cpu().numpy()
    n_same = int((labels == cfg.siamese.same_label).sum())
    emit({"phase": "verification", "config": "siamese_verification", **rep,
          "eer_stderr": verification.eer_stderr(rep["eer"], n_same, len(labels) - n_same),
          "auc_stderr": verification.auc_stderr(rep["auc"], n_same, len(labels) - n_same),
          "launches": launches, "b9_vs_plain": held, "seconds": seconds})
    out["verification"] = launches

    reset_counts()
    t0 = time.perf_counter()
    scores = model.score_support(table, table)
    launches = read_counts()
    seconds = time.perf_counter() - t0
    if launches != {**nothing, "weighted_l1": 1}:
        raise AssertionError(f"score_support launches {launches}, want weighted_l1 1")
    if scores.shape != (n_utts, n_utts) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"score_support: {tuple(scores.shape)}, finite "
                             f"{bool(torch.isfinite(scores).all())}")
    held = b9_scores_held("score_support", lambda: model.score_support(table, table))
    emit({"phase": "score_support", "config": "siamese_verification",
          "shape": list(scores.shape), "launches": launches, "b9_vs_plain": held,
          "seconds": seconds})
    out["score_support"] = launches
    return out


def run_siamese_train_slice(host, seed: int) -> dict:
    """``fit`` on config #2 (BCE, ``weighted_l1``) at full width, batch
    SIAMESE_BATCH pairs, TRAIN_STEPS steps, then one n-shot evaluation whose
    launches are counted apart; then a BCE and a contrastive step against
    their plain-version steps, held in f32 compute and reported in bf16.

    In bf16 the kernels' f32 statistics, summed in another order than their
    plain versions', flip a bf16 rounding of BatchNorm's affine now and then,
    and blocks 1-3 carry it on: the embeddings differ by ~1e-3 relative, as
    the classifier's do (its step's loss, 10.73, differs by 1.6e-3). The
    siamese BCE loss starts near 1.2 and reads |e1 - e2|, so its relative
    difference (1.4e-3 on the H100) exceeds STEP_LOSS_RTOL. In f32 only the
    kernels' own summation order is left, so f32 is where the steps are
    held."""
    base = siamese_config()
    cfg = base.replace(train=dataclasses.replace(
        base.train, batch_size=SIAMESE_BATCH, num_steps=TRAIN_STEPS,
        evaluate_every=TRAIN_STEPS, num_eval_tasks=500, seed=seed))
    losses, accs = [], []

    def on_step(i, m):
        losses.append(m["loss"])
        accs.append(m["accuracy"])

    copies = FusedBlocknTrain.cotangent_copies
    reset_counts()
    with evaluation_launches() as eval_counts:
        t0 = time.perf_counter()
        state, history = fit(cfg, host, device=DEVICE, verbose=False, on_step=on_step)
        total = read_counts()
        seconds = time.perf_counter() - t0
    train = {k: total[k] - eval_counts[k] for k in total}
    check_channels_last_path(FusedBlocknTrain.cotangent_copies - copies)
    S = TRAIN_STEPS
    want = {name: 0 for name in KERNELS}
    want.update(gather_whiten=2 * S, conv_block0_train=S, conv_block0_train_bwd=S,
                pool_fwd=3 * S, route_bwd=3 * S)
    want = with_epilogue(want)
    if train != want:
        raise AssertionError(f"siamese train launches {train}, want {want} (per step: B1 2, "
                             f"B4 1, B5 1, B7 3 + 3, bn_apply and bn_grad 4 each)")
    want_eval = {name: 0 for name in KERNELS}
    want_eval.update(gather_whiten=-(-len(host.labels) // 256), weighted_l1=1)
    if eval_counts != want_eval:
        raise AssertionError(f"siamese evaluation launches {eval_counts}, want {want_eval} "
                             f"(the model's own forward, then the head)")
    loss = torch.stack(losses).float().cpu()
    acc = torch.stack(accs).float().cpu()
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"non-finite siamese train loss: {loss.tolist()}")
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    if not last < first:
        raise AssertionError(f"siamese train loss did not fall: first 5 {first}, last 5 {last}")
    val_acc = history[-1]["val_1-shot_acc"]
    if not (bool(((acc >= 0) & (acc <= 1)).all()) and 0.0 <= val_acc <= 1.0):
        raise AssertionError(f"accuracy outside [0, 1]: {acc.tolist()}, val {val_acc}")

    store = device_store_for(cfg, host, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    pairs = sampling.sample_verification_batch(gen, store.speaker_utts, store.speaker_counts,
                                               SIAMESE_BATCH, cfg.siamese.same_label)
    x1 = fetch_batch(store, pairs.idx_1, cfg, gen)
    x2 = fetch_batch(store, pairs.idx_2, cfg, gen)
    held = {}
    for dtype in ("float32", "bfloat16"):
        for loss_name in ("bce", "contrastive"):
            lcfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, compute_dtype=dtype),
                               train=dataclasses.replace(cfg.train, loss=loss_name))
            model = SiameseNet(lcfg.encoder, lcfg.siamese, device=DEVICE)
            model.load_state_dict(from_flax(random_flax_variables(lcfg.encoder, 1, seed),
                                            lcfg.encoder))
            loss_fn = steps.siamese_loss_fn(model, lcfg)
            held[f"{loss_name}_{dtype}"] = held_steps(
                model, lcfg, lambda st, f=loss_fn: steps.train_on_pairs(
                    st, x1, x2, pairs.labels, None, f)[1], hold=dtype == "float32")
    emit({"phase": "siamese_train_slice", "config": "siamese_verification",
          "metric": "weighted_l1", "loss": "bce", "dtype": "bfloat16",
          "batch_pairs": SIAMESE_BATCH, "steps": S, "speakers": len(host.label_names),
          "launches": train, "eval_launches": eval_counts,
          "loss_first5_mean": first, "loss_last5_mean": last, "losses": loss.tolist(),
          "final_record": history[-1], "seconds": seconds, "plain_steps": held})
    return {"launches": train, "cfg": cfg, "store": store}


def host_us(fn, *args, iters: int = 200) -> float:
    """Host microseconds a call of ``fn(*args)``: the wall time to enqueue
    ``iters`` calls, after one, before waiting for the device."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def run_siamese_timing(sliced: dict, trained: dict, seed: int, card: str) -> dict:
    """B9 at B9_TIMING and B9_NSHOT beside its bound, its plain version, the
    broadcast form and ``torch.cdist`` (back to back, and B9 also queued,
    the device's time alone; the host microseconds of a call of B9's
    wrapper and of ``cdist``); the 500-task head scoring; the siamese train
    step at SIAMESE_BATCH pairs under the auto policy."""
    t0 = time.perf_counter()
    rows = {}
    for name, shape in (("timing", B9_TIMING), ("nshot", B9_NSHOT)):
        q, s, w, b = b9_inputs(70, *shape)
        work = weighted_l1_work(*shape)
        qw, sw = q * w.abs(), s * w.abs()

        def broadcast():
            return (q[:, :, None, :] - s[:, None, :, :]).abs() @ w + b

        rows[name] = {
            "shape": list(shape), "bytes": work["bytes"], "ops": work["ops"],
            **bound(work["bytes"], work["ops"], F32_INSTR_PER_S),
            "ms": time_fn(weighted_l1, q, s, w, b, iters=50)["mean_s"] * 1e3,
            "queued_ms": time_fn(weighted_l1, q, s, w, b, iters=50,
                                 queued=True)["mean_s"] * 1e3,
            "host_us": host_us(weighted_l1, q, s, w, b),
            "library_host_us": host_us(torch.cdist, qw, sw, 1.0),
            "plain_ms": time_fn(weighted_l1_reference, q, s, w, b, iters=3,
                                warmup=1)["mean_s"] * 1e3,
            "broadcast_ms": time_fn(broadcast, iters=10, warmup=2)["mean_s"] * 1e3,
            "library_ms": time_fn(torch.cdist, qw, sw, p=1.0, iters=20)["mean_s"] * 1e3,
            "library": "torch.cdist(q*|w|, s*|w|, p=1): the same sums for w >= 0, no bias",
        }
        del q, s, qw, sw
        torch.cuda.empty_cache()

    model, cfg, store = sliced["model"], sliced["cfg"], sliced["store"]
    table = sliced["table_bf16"]

    def score():
        return nshot.score_table(table, store, cfg, torch.Generator(device=DEVICE)
                                 .manual_seed(seed), 500, 1, 5, model=model)

    scoring = time_fn(score, iters=20, warmup=2)
    tcfg, tstore = trained["cfg"], trained["store"]
    tmodel = init_model(tcfg, 1, DEVICE, seed)
    state = init_state(tmodel, tcfg.train.clipnorm, tcfg.train.learning_rate)
    step, loss_fn = steps.make_siamese_train_step(tmodel, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = time_fn(step, state, tstore, gen, iters=20, warmup=2)
    train_step = {"batch_pairs": SIAMESE_BATCH, "rows": 2 * SIAMESE_BATCH,
                  "fused_block0": loss_fn.fused_block0, "blockn": loss_fn.blockn,
                  "step_ms": r["mean_s"] * 1e3, "step_p50_ms": r["p50_s"] * 1e3,
                  "pairs_per_s": SIAMESE_BATCH / r["mean_s"],
                  "utt_per_s": 2 * SIAMESE_BATCH / r["mean_s"],
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    layout = layout_profile(tcfg, 1, tstore, SIAMESE_BATCH, seed)
    emit({"phase": "siamese_timing", "card": card, "weighted_l1": rows,
          "nshot_scoring_500_tasks_ms": scoring["mean_s"] * 1e3,
          "nshot_scoring_500_tasks_p50_ms": scoring["p50_s"] * 1e3,
          "train_step": train_step, "train_step_layout": layout,
          "seconds": time.perf_counter() - t0})
    row = rows["timing"]
    return {"ms": {"weighted_l1": row["ms"]}, "plain_ms": {"weighted_l1": row["plain_ms"]},
            "bounds": {"weighted_l1": {k: row[k] for k in ("bound_ms", "bound_by")}},
            "library_ms": {"weighted_l1": row["library_ms"]}}


def losses_falling(name: str, losses: list, falling: bool = True) -> tuple[float, float]:
    """Every loss finite and (``falling``) the last five's mean below the
    first five's → the two means."""
    loss = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"{name}: non-finite train loss: {loss.tolist()}")
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    if falling and not last < first:
        raise AssertionError(f"{name}: train loss did not fall: first 5 {first}, last 5 {last}")
    return first, last


def counted_fit(cfg, *args, **kw) -> tuple:
    """``fit`` with the launch counters read around it, the evaluation's
    counted apart → ``(history, losses, train launches, evaluation
    launches, seconds)``."""
    losses = []
    reset_counts()
    with evaluation_launches() as eval_counts:
        t0 = time.perf_counter()
        _, history = fit(cfg, *args, device=DEVICE, verbose=False,
                         on_step=lambda i, m: losses.append(m["loss"]), **kw)
        total = read_counts()
        seconds = time.perf_counter() - t0
    return history, losses, {k: total[k] - eval_counts[k] for k in total}, eval_counts, seconds


def with_epilogue(want: dict) -> dict:
    """``want`` with the BatchNorm epilogue pair's launches: one ``bn_apply``
    a fused block's forward (B4, B7 in either mode) and one ``bn_grad`` a
    fused block's backward (B5, B7 in either mode)."""
    return {**want,
            "bn_apply": sum(want.get(k, 0) for k in ("conv_block0_train", "pool_fwd",
                                                     "pool_fwd_idx")),
            "bn_grad": sum(want.get(k, 0) for k in ("conv_block0_train_bwd", "route_bwd",
                                                    "route_bwd_idx"))}


def expect_launches(name: str, got: dict, **want) -> None:
    full = {k: 0 for k in KERNELS}
    full.update(want)
    full = with_epilogue(full)
    if got != full:
        raise AssertionError(f"{name} launches {got}, want {full}")


def mel_train_config(seed: int, batch: int = None):
    """Config #4 at full width (filters 128, embedding 64, dropout 0.05,
    3 s at 16 kHz, downsampling 1) as mel_train_slice trains it."""
    base = melspec_2d()
    return base.replace(train=dataclasses.replace(
        base.train, batch_size=batch or MEL_TRAIN_BATCH, num_steps=TRAIN_STEPS,
        evaluate_every=TRAIN_STEPS, num_eval_tasks=500, seed=seed))


def run_mel_train_slice(host, seed: int) -> dict:
    """``fit`` on config #4 at full width, batch MEL_TRAIN_BATCH, TRAIN_STEPS
    steps, then one n-shot evaluation counted apart: per step B1 1 and B6 1
    (the 2D convs are cuDNN's; no gradient reaches B6), the evaluation B1
    and B6 only. Losses finite and falling. Then one step from fixed weights
    and a fixed batch (dropout masks from one seed) through the kernels and
    through their plain versions, held in f32 compute and reported in bf16."""
    cfg = mel_train_config(seed)
    history, losses, train, eval_counts, seconds = counted_fit(cfg, host)
    S = TRAIN_STEPS
    expect_launches("mel train", train, gather_whiten=S, log_mel=S)
    chunks = -(-len(host.labels) // 256)
    expect_launches("mel evaluation", eval_counts, gather_whiten=chunks, log_mel=chunks)
    first, last = losses_falling("mel train", losses)
    val_acc = history[-1]["val_1-shot_acc"]
    if not 0.0 <= val_acc <= 1.0:
        raise AssertionError(f"mel accuracy {val_acc} outside [0, 1]")
    store = device_store_for(cfg, host, DEVICE)
    n = len(host.label_names)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = sampling.sample_classifier_batch(gen, store.labels.shape[0], MEL_TRAIN_BATCH, DEVICE)
    x, y = fetch_batch(store, idx, cfg, gen), store.labels[idx]
    held = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, compute_dtype=dtype))
        model = mel_model(dcfg, n, seed)
        loss_fn = steps.classifier_loss_fn(model, dcfg)

        def run(state, f=loss_fn):
            drop = torch.Generator(device=DEVICE).manual_seed(seed + 1)
            return steps.train_on_batch(state, x, y, drop, f)[1]

        held[dtype] = held_steps(model, dcfg, run, hold=dtype == "float32")
    emit({"phase": "mel_train_slice", "config": "melspec_2d", "dtype": "bfloat16",
          "batch": MEL_TRAIN_BATCH, "steps": S, "speakers": n, "dropout": cfg.encoder.dropout,
          "launches": train, "eval_launches": eval_counts, "loss_first5_mean": first,
          "loss_last5_mean": last, "losses": torch.stack(losses).float().tolist(),
          "final_record": history[-1], "seconds": seconds, "plain_steps": held})
    return {"launches": train, "store": store, "n_classes": n}


def step_profile(step_fn) -> dict:
    """Steps under the profiler: the device's idle share, window, events and
    its ms a step by kernel (the top 15)."""
    prof = stage_profile.profile([("step", lambda _: step_fn())], batches=3)
    return {k: prof[k] for k in ("window_ms_per_batch", "idle_share", "device_events_per_batch",
                                 "device_ms_by_op_per_batch", "error") if k in prof}


def run_mel_train_timing(trained: dict, seed: int, card: str) -> None:
    """Config #4's train step (B1, B6, cuDNN's 2D convs, autograd) at each
    batch of MEL_TRAIN_TIMING_BATCHES: ms, utt/s and peak memory, and the
    device's idle share under the profiler."""
    t0 = time.perf_counter()
    rows = []
    for bt in MEL_TRAIN_TIMING_BATCHES:
        cfg = mel_train_config(seed, bt)
        model = init_model(cfg, trained["n_classes"], DEVICE, seed)
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        step, _ = steps.make_classifier_train_step(model, cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = time_fn(step, state, trained["store"], gen, iters=10 if bt <= 256 else 3, warmup=2)
        rows.append({"batch": bt, "step_ms": r["mean_s"] * 1e3, "step_p50_ms": r["p50_s"] * 1e3,
                     "utt_per_s": bt / r["mean_s"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     **step_profile(lambda: step(state, trained["store"], gen))})
        del model, state, step
    emit({"phase": "mel_train_timing", "card": card, "config": "melspec_2d", "steps": rows,
          "seconds": time.perf_counter() - t0})


def corpus_config(base, root: str, seed: int, batch: int, steps_: int = None):
    """``base`` reading the corpus at ``root``: CORPUS_SUBSETS[0] for
    training, CORPUS_SUBSETS[1] for validation; ``steps_`` steps at ``batch``
    (TRAIN_STEPS by default) and one evaluation of 500 tasks at the end."""
    steps_ = steps_ or TRAIN_STEPS
    return base.replace(
        data=dataclasses.replace(base.data, data_root=root, subsets=CORPUS_SUBSETS[:1],
                                 val_subsets=CORPUS_SUBSETS[1:]),
        train=dataclasses.replace(base.train, batch_size=batch, num_steps=steps_,
                                  evaluate_every=steps_, num_eval_tasks=500, seed=seed))


def decode_rates(ds) -> dict:
    """Host FLAC decode rate of ``ds``'s files in files/s: ``read_batch``
    over all of them (the C++ threads), and ``DecodeCache.get_many`` cold
    (every file decoded) and warm (every file cached)."""
    paths = [ds.path_of(int(i)) for i in ds.index.id]
    ids = np.asarray(ds.index.id)
    t0 = time.perf_counter()
    flac_ext.read_batch(paths)
    t_batch = time.perf_counter() - t0
    cache = DecodeCache(ds)
    t0 = time.perf_counter()
    cache.get_many(ids)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache.get_many(ids)
    t_warm = time.perf_counter() - t0
    return {"files": len(paths), "read_batch_files_per_s": len(paths) / t_batch,
            "cache_cold_files_per_s": len(paths) / t_cold,
            "cache_warm_files_per_s": len(paths) / max(t_warm, 1e-9),
            "host_cpus": os.cpu_count()}


def pipeline_step_rows(cfg, ds, dstore, n_classes: int, seed: int) -> list:
    """Config #1's train step through the device pipeline (B1 from the store
    on the card), the streaming pipeline (host-cut batches, pinned, no B1)
    and the streaming step on three batches taken from the pipeline before
    it was closed (the step alone, with no producer thread beside it) at each
    batch of TRAIN_TIMING_BATCHES: utt/s over back-to-back steps, peak
    memory, and the device's idle share under the profiler."""
    rows = []
    for bt in TRAIN_TIMING_BATCHES:
        bcfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=bt))
        for name in ("device", "streaming", "streaming_prefetched"):
            model = init_model(bcfg, n_classes, DEVICE, seed)
            state = init_state(model, bcfg.train.clipnorm, bcfg.train.learning_rate)
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            stream = None
            if name == "device":
                step, _ = steps.make_classifier_train_step(model, bcfg)
                fn = lambda: step(state, dstore, gen)  # noqa: E731
            else:
                step, _ = steps.make_streaming_classifier_step(model, bcfg)
                stream = StreamingPipeline(ds, bcfg, seed=seed)
                if name == "streaming":
                    fn = lambda: step(state, *next(stream), gen)  # noqa: E731
                else:
                    batches = itertools.cycle([next(stream) for _ in range(3)])
                    stream.close()
                    fn = lambda: step(state, *next(batches), gen)  # noqa: E731
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                r = throughput(fn, items_per_call=bt, iters=20 if bt <= 256 else 4, warmup=2)
                rows.append({"batch": bt, "pipeline": name, "utt_per_s": r["items_per_sec"],
                             "step_ms": r["sec_per_call"] * 1e3,
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                             **step_profile(fn)})
            finally:
                if stream is not None:
                    stream.close()
            del model, state, step
    return rows


def run_corpus_slice(root: str, seed: int, card: str) -> dict:
    """The port's ``generate_corpus`` writes a FLAC corpus (CORPUS_SPEC,
    two subsets) and ``fit(cfg)`` trains config #1 at full width from it with
    no store given, batch 32, TRAIN_STEPS steps, once through the device
    pipeline (per step B1 1, B4 1, B5 1, B7 3 + 3) and once through the
    streaming pipeline (B4 1, B5 1, B7 3 + 3, no B1), each evaluated on the
    validation subset at ``stochastic=False`` (counted apart: B1 only);
    config #2 (``weighted_l1``, BCE) trains CORPUS_SIAMESE_STEPS steps of 64
    pairs through the streaming pipeline (B4 1, B5 1, B7 3 + 3; its
    evaluation B1 and B9). Losses finite, and falling in config #1's runs.
    Then the host's FLAC decode rate and the streaming step against the
    device-pipeline step at each batch of TRAIN_TIMING_BATCHES."""
    t0 = time.perf_counter()
    generate_corpus(root, CORPUS_SUBSETS, SyntheticSpec(**CORPUS_SPEC))
    write_seconds = time.perf_counter() - t0
    cfg = corpus_config(classifier_baseline(), root, seed, TRAIN_BATCH)
    t0 = time.perf_counter()
    ds = dataset_from_config(cfg.data)
    val = dataset_from_config(dataclasses.replace(cfg.data, subsets=CORPUS_SUBSETS[1:],
                                                  stochastic=False))
    index_seconds = time.perf_counter() - t0
    S = TRAIN_STEPS
    val_chunks = -(-len(val) // 256)
    runs, launches = {}, {}
    for pipeline in ("device", "streaming"):
        history, losses, train, eval_counts, seconds = counted_fit(cfg, pipeline=pipeline)
        expect_launches(f"corpus {pipeline}", train, gather_whiten=S if pipeline == "device" else 0,
                        conv_block0_train=S, conv_block0_train_bwd=S, pool_fwd=3 * S,
                        route_bwd=3 * S)
        expect_launches(f"corpus {pipeline} evaluation", eval_counts, gather_whiten=val_chunks)
        first, last = losses_falling(f"corpus {pipeline}", losses)
        runs[pipeline] = {"launches": train, "eval_launches": eval_counts,
                          "loss_first5_mean": first, "loss_last5_mean": last,
                          "losses": torch.stack(losses).float().tolist(),
                          "final_record": history[-1], "seconds": seconds}
        launches[f"corpus_{pipeline}"] = train
    scfg = corpus_config(siamese_config(), root, seed, SIAMESE_BATCH, CORPUS_SIAMESE_STEPS)
    history, losses, train, eval_counts, seconds = counted_fit(scfg, pipeline="streaming")
    n = CORPUS_SIAMESE_STEPS
    expect_launches("corpus siamese streaming", train, conv_block0_train=n,
                    conv_block0_train_bwd=n, pool_fwd=3 * n, route_bwd=3 * n)
    expect_launches("corpus siamese evaluation", eval_counts, gather_whiten=val_chunks,
                    weighted_l1=1)
    first, last = losses_falling("corpus siamese streaming", losses, falling=False)
    runs["siamese_streaming"] = {"launches": train, "eval_launches": eval_counts,
                                 "loss_first5_mean": first, "loss_last5_mean": last,
                                 "losses": torch.stack(losses).float().tolist(),
                                 "final_record": history[-1], "seconds": seconds}
    launches["corpus_siamese"] = train
    t0 = time.perf_counter()
    rates = decode_rates(ds)
    dstore = device_store_for(cfg, ds.to_store(30.0), DEVICE)
    step_rows = pipeline_step_rows(cfg, ds, dstore, ds.num_classes(), seed)
    emit({"phase": "corpus_slice", "card": card, "config": "classifier_baseline",
          "corpus": {**CORPUS_SPEC, "subsets": list(CORPUS_SUBSETS), "files": len(ds) + len(val),
                     "write_seconds": write_seconds, "index_seconds": index_seconds},
          "batch": TRAIN_BATCH, "steps": S, "runs": runs, "decode": rates,
          "train_steps": step_rows, "timing_seconds": time.perf_counter() - t0})
    return launches


def run_streaming_embed(root: str, seed: int) -> dict:
    """On the corpus of corpus_slice (its training subset), the streamed
    table (``embed_all_streaming``: host-cut offset-0 fragments, no B1)
    against ``embed_all`` on the device store of the same dataset, row for
    row (min cosine ≥ TABLE_MIN_COSINE), with the launch counters read around
    the streamed run: config #1 in bf16 (``fast``: B2 → B8 × 3), in int8
    (qvars from ``quantize_from_frags`` on the first 256 offset-0
    fragments: B2 requant → B3 × 3), and config #4 in bf16 (B6)."""
    out = {}
    for path, base in (("streaming_bf16", classifier_baseline()),
                       ("streaming_int8", classifier_baseline()),
                       ("streaming_mel", melspec_2d())):
        cfg = corpus_config(base, root, seed, TRAIN_BATCH)
        ds = dataset_from_config(cfg.data)
        n = ds.num_classes()
        if cfg.mode == "melspec2d":
            model = mel_model(cfg, n, seed)
        else:
            model = SpeakerClassifier(cfg.encoder, n, device=DEVICE)
            model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n, seed),
                                            cfg.encoder))
        fast, qvars, calib = path == "streaming_bf16", None, None
        if path == "streaming_int8":
            batches = iter_embed_batches(ds, cfg, 256)
            frags, calib = next(batches)
            batches.close()
            qvars = quantize_from_frags(model, cfg, frags[:calib])
        chunks = -(-len(ds) // 256)
        reset_counts()
        t0 = time.perf_counter()
        table = nshot.embed_all_streaming(model, cfg, ds, fast=fast, qvars=qvars)
        launches = read_counts()
        seconds = time.perf_counter() - t0
        want = ({"log_mel": chunks} if cfg.mode == "melspec2d" else
                {"conv_block0": chunks, "conv_blockn": 3 * chunks} if fast else
                {"conv_block0": chunks, "quant_block": 3 * chunks})
        expect_launches(path, launches, **want)
        store = device_store_for(cfg, ds.to_store(), DEVICE)
        device_table = nshot.embed_all(model, store, cfg, fast=fast, qvars=qvars)
        d = cfg.encoder.embedding_dim
        check_table(path, table, len(ds), d, 0.0)
        cos = min_cosine(table, device_table)
        if cos < TABLE_MIN_COSINE:
            raise AssertionError(f"{path}: streamed table against the device store's: "
                                 f"min cosine {cos}")
        out[path] = {"config": cfg.name, "utterances": len(ds), "launches": launches,
                     "calibration_rows": calib, "min_cosine_vs_device_store": cos,
                     "seconds": seconds}
    emit({"phase": "streaming_embed", "cosine_tolerance": TABLE_MIN_COSINE, **out})
    return {path: r["launches"] for path, r in out.items()}


def run_cli(name: str, module, argv: list, exit_codes=(0,)) -> dict:
    """``module.main(argv)`` in-process with the launch counters set to 0
    before it and read after it, its standard output kept →
    ``{"name", "argv", "result", "stdout", "exit", "launches", "seconds"}``.
    A ``SystemExit`` passes only with a code in ``exit_codes`` (the int8
    gate's documented 2 on fail)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    code, result = 0, None
    with contextlib.redirect_stdout(buf):
        try:
            result = module.main(argv)
        except SystemExit as e:
            if e.code not in exit_codes:
                raise
            code = e.code
    launches = read_counts()
    return {"name": name, "argv": argv, "result": result, "stdout": buf.getvalue(),
            "exit": code, "launches": launches, "seconds": time.perf_counter() - t0}


def printed_records(run: dict) -> list:
    return [json.loads(line) for line in run["stdout"].splitlines() if line.startswith("{")]


def check_records(name: str, records: list, int8: bool) -> None:
    """The protocol's records in form: 4 accuracy and 2 verification records
    of the manifest, finite, accuracy, EER and AUC in [0, 1], not comparable
    (the corpus is synthetic), on the replayed key stream."""
    want = [e["name"] for e in load_manifest()["entries"]] + [
        e["name"] for e in load_manifest()["verification"]["entries"]]
    if [r["entry"] for r in records] != want:
        raise AssertionError(f"{name}: records {[r['entry'] for r in records]}, want {want}")
    for r in records:
        values = [r[k] for k in ("accuracy", "stderr", "eer", "auc", "eer_stderr", "auc_stderr")
                  if k in r]
        if not all(np.isfinite(v) for v in values):
            raise AssertionError(f"{name}: non-finite record {r}")
        if not all(0.0 <= r[k] <= 1.0 for k in ("accuracy", "eer", "auc") if k in r):
            raise AssertionError(f"{name}: a metric outside [0, 1]: {r}")
        if (r["int8"] is not int8 or r["key_stream"] != jax_random.KEY_STREAM
                or r["corpus_verified"] or r.get("comparable_to_reference", r.get("comparable"))):
            raise AssertionError(f"{name}: record fields {r}")


def train_launches(steps_run: int, evals: int, val_chunks: int, rows_a_step: int = 1,
                   head_scores: int = 0) -> dict:
    """A train CLI's launches: per step B1 ``rows_a_step`` (2 for pairs), B4 1,
    B5 1, B7 3 + 3; per evaluation B1 once a chunk of the validation store
    and B9 ``head_scores``."""
    return dict(gather_whiten=rows_a_step * steps_run + evals * val_chunks,
                conv_block0_train=steps_run, conv_block0_train_bwd=steps_run,
                pool_fwd=3 * steps_run, route_bwd=3 * steps_run,
                weighted_l1=evals * head_scores)


def evaluations(start: int, stop: int, every: int) -> int:
    return sum(1 for i in range(start, stop) if (i + 1) % every == 0 or i + 1 == stop)


def replay_ms(root: str) -> dict:
    """Host ms of the key-stream replay at the manifest's settings on the
    dev-clean store's index (min and mean of 5): 500 tasks of each accuracy
    entry, and 2,000 pairs."""
    ds = dataset_from_config(dataclasses.replace(classifier_baseline().data, data_root=root,
                                                 subsets=("dev-clean",), stochastic=False))
    host = ds.to_store(4.0)
    m = load_manifest()
    out = {}

    def timed(fn):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return {"min_ms": min(ts), "mean_ms": sum(ts) / len(ts)}

    for e in m["entries"]:
        out[f"tasks_{e['num_tasks']}_{e['n_shot']}shot_{e['k_way']}way"] = timed(
            lambda e=e: jax_random.nshot_tasks(jax_random.PRNGKey(m["task_seed"]),
                                               host.speaker_utts, host.speaker_counts,
                                               e["num_tasks"], e["n_shot"], e["k_way"]))
    n_pairs = m["verification"]["entries"][0]["num_pairs"]
    out[f"pairs_{n_pairs}"] = timed(lambda: jax_random.verification_pairs(
        jax_random.PRNGKey(m["verification"]["pair_seed"]), host.speaker_utts,
        host.speaker_counts, n_pairs, m["verification"]["same_label"]))
    return out


def batch1_request(root: str, ckpt: str) -> dict:
    """``single_request_latency`` of one utterance through the soak
    checkpoint's bf16 serving path (B1 → B2 → B8 × 3): the call to the
    embedding in host memory, host clock and CUDA events."""
    cfg = classifier_baseline()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_root=root, subsets=("dev-clean",),
                                               stochastic=False))
    ds = dataset_from_config(cfg.data)
    model, step = restore_model(cfg, ds.num_classes(), ckpt, "best", DEVICE)
    store = device_store_for(cfg, ds.to_store(4.0), DEVICE)
    idx = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def request():
        with torch.inference_mode():
            return fast_embed(model.encoder, fetch_batch(store, idx, cfg, stochastic=False))

    r = single_request_latency(request, samples=20, warmup=3)
    return {"step": step, **{k[:-2] + "_ms": v * 1e3 for k, v in r.items()}}


def run_protocol_slice(root: str, seed: int, card: str) -> dict:
    """The five experiment CLIs in-process, on the card, at full config #1
    and #2 width, on a WAV corpus the port's ``generate_corpus`` writes
    (PROTOCOL_TRAIN_SPEC, PROTOCOL_EVAL_SPEC), each with the launch counters
    read around it:

    1. ``train_classifier`` SOAK_STEPS[0] steps at batch TRAIN_BATCH with
       ``--val-subsets dev-clean`` and a checkpoint directory, then again to
       SOAK_STEPS[1] in it, which prints ``resumed from step``;
    2. ``evaluate --protocol --allow-corpus-mismatch`` on the best checkpoint
       (B1, the model's forward), then with ``--int8`` (B1 → B2 requant →
       B3 × 3): the manifest's 6 records each, in form;
    3. ``evaluate --protocol --int8-gate``: the int8 decision gate's verdict
       and its checks, reported (exit 2 on fail is the verdict, not held);
    4. ``evaluate --k-sweep`` over SWEEP_K ``--fast --verification``
       SWEEP_PAIRS (B1 → B2 → B8 × 3), the points past 12 speakers skipped;
    5. ``train_siamese`` (``weighted_l1``) SIAMESE_CLI_STEPS steps, then
       ``evaluate --mode siamese --protocol``, scored by the head (B9);
    6. ``embed --int8 --save-qvars``, then ``embed --qvars``: equal tables;
       ``visualize_embeddings``: its ``.npz``;
    7. the replay's host ms at the manifest's settings and one batch-1
       request through the checkpoint (not counted on a path).
    Returns each command's launches by path name."""
    t0 = time.perf_counter()
    generate_corpus(root, ("train-clean-100",), SyntheticSpec(**PROTOCOL_TRAIN_SPEC))
    # A second call for the held-out subsets (its own speakers and seed);
    # it rewrites SPEAKERS.TXT, which only the sex labels read.
    generate_corpus(root, ("dev-clean", "test-clean"), SyntheticSpec(**PROTOCOL_EVAL_SPEC))
    write_seconds = time.perf_counter() - t0
    base = ["--device", DEVICE, "--data-root", root, *CLI_WIDTH]
    ckpt, sckpt = os.path.join(root, "ckpt"), os.path.join(root, "siamese_ckpt")
    n_eval = PROTOCOL_EVAL_SPEC["n_speakers"] * PROTOCOL_EVAL_SPEC["utterances_per_speaker"]
    chunks = -(-n_eval // 256)  # of one held-out subset's store
    runs = []
    train_argv = base + ["--subsets", "train-clean-100", "--val-subsets", "dev-clean",
                         "--batch-size", str(TRAIN_BATCH), "--evaluate-every", str(SOAK_EVERY),
                         "--seed", str(seed), "--checkpoint-dir", ckpt,
                         "--log-path", os.path.join(root, "classifier.jsonl")]
    start = 0
    for i, stop in enumerate(SOAK_STEPS):
        run = run_cli(f"train_classifier_{i}", train_classifier_cli,
                      train_argv + ["--num-steps", str(stop)])
        expect_launches(run["name"], run["launches"], **train_launches(
            stop - start, evaluations(start, stop, SOAK_EVERY), chunks))
        if ("resumed from step" in run["stdout"]) != (i > 0):
            raise AssertionError(f"{run['name']}: resume line: {run['stdout'][-2000:]}")
        losses = [r["loss"] for r in run["result"]]
        if not all(np.isfinite(losses)) or not all(0 <= r["val_1-shot_acc"] <= 1
                                                   for r in run["result"]):
            raise AssertionError(f"{run['name']}: records {run['result']}")
        runs.append(run)
        start = stop
    proto = base + ["--checkpoint-dir", ckpt, "--protocol", "--allow-corpus-mismatch"]
    bf16 = run_cli("evaluate_protocol", evaluate_cli, proto)
    int8 = run_cli("evaluate_protocol_int8", evaluate_cli, proto + ["--int8"])
    gate = run_cli("evaluate_int8_gate", evaluate_cli, proto + ["--int8-gate"],
                   exit_codes=(0, 2))
    check_records("protocol bf16", bf16["result"], False)
    check_records("protocol int8", int8["result"], True)
    expect_launches("protocol bf16", bf16["launches"], gather_whiten=2 * chunks)
    int8_launches = dict(gather_whiten=4 * chunks, conv_block0=2 * chunks,
                         quant_block=6 * chunks)
    expect_launches("protocol int8", int8["launches"], **int8_launches)
    expect_launches("int8 gate", gate["launches"], **{**int8_launches,
                                                     "gather_whiten": 6 * chunks})
    verdict = printed_records(gate)[-1]
    if verdict["int8_accuracy_gate"] != ("pass" if gate["exit"] == 0 else "fail"):
        raise AssertionError(f"int8 gate: exit {gate['exit']}, verdict {verdict}")
    if len(verdict["checks"]) != 8:
        raise AssertionError(f"int8 gate: {len(verdict['checks'])} checks, want 8")
    sweep = run_cli("evaluate_sweep", evaluate_cli, base + [
        "--checkpoint-dir", ckpt, "--k-sweep", *map(str, SWEEP_K), "--fast",
        "--verification", str(SWEEP_PAIRS), "--sweep-out", os.path.join(root, "sweep")])
    expect_launches("sweep", sweep["launches"], gather_whiten=2 * chunks,
                    conv_block0=2 * chunks, conv_blockn=6 * chunks)
    points = sweep["result"]["sweep"]
    n_speakers = PROTOCOL_EVAL_SPEC["n_speakers"]
    if [p["k_way"] for p in points if "skipped" in p] != [
            k for _ in (1, 5) for k in range(SWEEP_K[0], SWEEP_K[1] + 1) if k > n_speakers]:
        raise AssertionError(f"sweep: skipped points {points}")
    if not all(0 <= p["accuracy"] <= 1 for p in points if "accuracy" in p):
        raise AssertionError(f"sweep: points {points}")
    siamese = run_cli("train_siamese", train_siamese_cli, base + [
        "--subsets", "train-clean-100", "--val-subsets", "dev-clean",
        "--distance-metric", "weighted_l1", "--batch-size", str(SIAMESE_BATCH),
        "--num-steps", str(SIAMESE_CLI_STEPS), "--evaluate-every", str(SIAMESE_CLI_STEPS),
        "--seed", str(seed), "--checkpoint-dir", sckpt,
        "--log-path", os.path.join(root, "siamese.jsonl")])
    expect_launches("siamese train", siamese["launches"], **train_launches(
        SIAMESE_CLI_STEPS, 1, chunks, rows_a_step=2, head_scores=1))
    siamese_proto = run_cli("evaluate_siamese_protocol", evaluate_cli, base + [
        "--mode", "siamese", "--distance-metric", "weighted_l1", "--checkpoint-dir", sckpt,
        "--protocol", "--allow-corpus-mismatch"])
    check_records("siamese protocol", siamese_proto["result"], False)
    expect_launches("siamese protocol", siamese_proto["launches"], gather_whiten=2 * chunks,
                    weighted_l1=6)
    emb = base + ["--checkpoint-dir", ckpt, "--subsets", "dev-clean"]
    qvars = os.path.join(root, "qvars.npz")
    embed_a = run_cli("embed_int8_save_qvars", embed_cli, emb + [
        "--int8", "--save-qvars", qvars, "--out", os.path.join(root, "a.npz")])
    embed_b = run_cli("embed_qvars", embed_cli, emb + [
        "--qvars", qvars, "--out", os.path.join(root, "b.npz")])
    expect_launches("embed int8", embed_a["launches"], gather_whiten=2 * chunks,
                    conv_block0=chunks, quant_block=3 * chunks)
    expect_launches("embed qvars", embed_b["launches"], gather_whiten=chunks,
                    conv_block0=chunks, quant_block=3 * chunks)
    table_a, table_b = embed_a["result"][0], embed_b["result"][0]
    if not (np.isfinite(table_a).all() and np.array_equal(table_a, table_b)):
        raise AssertionError("embed: the table served from the saved qvars differs")
    vis = run_cli("visualize_embeddings", visualize_cli, base + [
        "--checkpoint-dir", ckpt, "--out", os.path.join(root, "vis")])
    expect_launches("visualize", vis["launches"], gather_whiten=chunks)
    if not os.path.isfile(os.path.join(root, "vis.npz")):
        raise AssertionError("visualize: no .npz")
    commands = runs + [bf16, int8, gate, sweep, siamese, siamese_proto, embed_a, embed_b, vis]
    emit({"phase": "protocol_slice", "card": card, "config": ["classifier_baseline",
                                                              "siamese_verification"],
          "corpus": {"train": PROTOCOL_TRAIN_SPEC, "eval": PROTOCOL_EVAL_SPEC,
                     "write_seconds": write_seconds},
          "soak_steps": list(SOAK_STEPS), "batch": TRAIN_BATCH,
          "soak_records": runs[0]["result"] + runs[1]["result"],
          "protocol_bf16": bf16["result"], "protocol_int8": int8["result"],
          "int8_gate": verdict, "int8_gate_exit": gate["exit"],
          "sweep": points, "sweep_verification": sweep["result"]["verification"],
          "siamese_records": siamese["result"], "siamese_protocol": siamese_proto["result"],
          "embed": {"shape": list(table_a.shape), "int8_tables_equal": True},
          "replay_host_ms": replay_ms(root), "batch1_request_ms": batch1_request(root, ckpt),
          "commands": [{k: c[k] for k in ("name", "argv", "exit", "seconds", "launches")}
                       for c in commands]})
    return {"cli_train": {k: runs[0]["launches"][k] + runs[1]["launches"][k] for k in KERNELS},
            "cli_protocol_bf16": bf16["launches"], "cli_protocol_int8": int8["launches"],
            "cli_int8_gate": gate["launches"], "cli_sweep": sweep["launches"],
            "cli_siamese_train": siamese["launches"],
            "cli_siamese_protocol": siamese_proto["launches"],
            "cli_embed": {k: embed_a["launches"][k] + embed_b["launches"][k] for k in KERNELS},
            "cli_visualize": vis["launches"]}


@contextlib.contextmanager
def process_group():
    """The default process group at world size 1 (NCCL on the card; no
    fallback: a failed init raises) and its ``data`` mesh, for one phase;
    destroyed after it, so that later phases run as before."""
    dist.init_process_group(PG_BACKEND, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield data_mesh()
    finally:
        dist.destroy_process_group()


def collective_ms(fn, *args) -> float:
    """CUDA-event ms of one call of a collective (queued, after warm-up)."""
    return time_fn(fn, *args, iters=30, warmup=5)["mean_s"] * 1e3


def scorer_ms(scorer, *args) -> float:
    """Host ms of one scorer call, its tasks' replay and its result's wait
    included: the best of three."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer(*args)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def run_pod_slice(sliced: dict, siamese: dict, gate: dict, seed: int, card: str) -> dict:
    """Config #5 at config #1's full width, world size 1 through NCCL:
    ``pod_evaluate`` on a synthetic stand-in for test-clean (POD_STORE),
    bf16 (B1, the model's forward) and int8 (the fidelity gate's qvars: B1 →
    B2 requant → B3), at the manifest's four entries' (n, k), 500 tasks each
    on its ``task_seed`` key, and config #2's siamese net scored by its head
    (B9); each accuracy held equal to the single-device ``nshot.evaluate``
    on the same key, the pod table equal to ``embed_all``'s, the three
    sharded distances equal to ``pairwise_sq_euclidean`` over the table, the
    launches counted; the embed, scorer and collective times."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model = sliced["cfg"], sliced["model"]
    t0 = time.perf_counter()
    host = synthetic_store(seed, **POD_STORE)
    store_seconds = time.perf_counter() - t0
    n_utts = host.audio.shape[0]
    store = device_store_for(cfg, host, DEVICE)
    scfg, smodel = siamese["cfg"], siamese["model"]
    sstore = device_store_for(scfg, host, DEVICE)
    mean_s = float(host.lengths.mean()) / host.sample_rate
    store_rec = {"synthetic": True, "speakers": POD_STORE["n_speakers"], "utterances": n_utts,
                 "seconds": [POD_STORE["min_seconds"], POD_STORE["max_seconds"]],
                 "mean_seconds": mean_s, "host_gb": host.audio.nbytes / 1e9,
                 "device_gb": store.audio.nbytes / 1e9, "build_seconds": store_seconds}
    del host
    manifest = load_manifest()
    key = jax_random.PRNGKey(int(manifest["task_seed"]))
    settings = [(e["n_shot"], e["k_way"]) for e in manifest["entries"]]
    chunks = -(-n_utts // 256)  # embed_all's batch_size
    n_mid = len(model.encoder.blocks) - 1
    idx = torch.arange(n_utts, dtype=torch.int32, device=DEVICE)
    out, record = {}, {"phase": "pod_slice", "config": cfg.name, "world_size": 1,
                       "backend": PG_BACKEND, "store": store_rec, "card": card,
                       "tasks": POD_TASKS, "settings": settings, "paths": {}}
    with process_group() as mesh:
        for path, qvars in (("pod_bf16", None), ("pod_int8", gate["qvars"])):
            table = nshot.embed_all(model, store, cfg, qvars=qvars)
            reset_counts()
            t0 = time.perf_counter()
            accs = [pod_eval.pod_evaluate(model, store, cfg, mesh, key, num_tasks=POD_TASKS,
                                          n=n, k=k, qvars=qvars) for n, k in settings]
            launches = read_counts()
            seconds = time.perf_counter() - t0
            calls = len(settings) * chunks
            want = dict(gather_whiten=calls)
            if qvars is not None:
                want.update(conv_block0=calls, quant_block=n_mid * calls)
            expect_launches(path, launches, **want)
            single = [nshot.evaluate(model, store, cfg, key, num_tasks=POD_TASKS, n=n, k=k,
                                     qvars=qvars, table=table) for n, k in settings]
            if accs != single:
                raise AssertionError(f"{path}: pod accuracies {accs} != single-device {single}")
            embed = pod_eval.make_sharded_embed_table_fn(model, cfg, mesh, qvars=qvars)
            pod_table = embed(store, idx)
            if not torch.equal(pod_table, table):
                raise AssertionError(f"{path}: the pod table is not embed_all's")
            check_table(path, pod_table, n_utts, cfg.encoder.embedding_dim, accs[0])
            embed_s = time_fn(embed, store, idx, iters=3, warmup=1)["mean_s"]
            record["paths"][path] = {"accuracy": accs, "single_device_accuracy": single,
                                     "launches": launches, "seconds": seconds,
                                     "table_embed_s": embed_s, "utt_per_s": n_utts / embed_s}
            out[path] = launches
            if qvars is None:
                bf16_table = table

        reset_counts()
        t0 = time.perf_counter()
        acc = pod_eval.pod_evaluate(smodel, sstore, scfg, mesh, key, num_tasks=POD_TASKS,
                                    n=1, k=5)
        launches = read_counts()
        seconds = time.perf_counter() - t0
        expect_launches("pod_siamese", launches, gather_whiten=chunks, weighted_l1=1)
        single = nshot.evaluate(smodel, sstore, scfg, key, num_tasks=POD_TASKS, n=1, k=5)
        if acc != single:
            raise AssertionError(f"pod_siamese: pod accuracy {acc} != single-device {single}")
        record["paths"]["pod_siamese"] = {"config": scfg.name, "metric": "weighted_l1",
                                          "accuracy": acc, "single_device_accuracy": single,
                                          "launches": launches, "seconds": seconds}
        out["pod_siamese"] = launches

        t = bf16_table
        dense = dist_ops.pairwise_sq_euclidean(t, t)
        sharded = {"sharded_sq_euclidean": sharded_distance.sharded_sq_euclidean(t, t, mesh),
                   "ring_sq_euclidean": sharded_distance.ring_sq_euclidean(t, t, mesh)}
        for name, got in sharded.items():
            if not torch.equal(got, dense):
                raise AssertionError(f"{name} differs from pairwise_sq_euclidean")
        nearest = sharded_distance.sharded_nearest_support(t, t, mesh)
        if not torch.equal(nearest, dense.argmin(dim=1)):
            raise AssertionError("sharded_nearest_support differs from the dense argmin")
        record["distances"] = {"shape": [n_utts, n_utts, t.shape[1]], "held": "equal"}

        utts, counts = store.speaker_utts, store.speaker_counts
        record["scorer_ms"] = {}
        for tasks in POD_SCORER_TASKS:
            scorer = pod_eval.make_sharded_task_scorer(mesh, tasks, 1, 5)
            t0 = time.perf_counter()
            jax_random.nshot_tasks(key, utts.cpu().numpy(), counts.cpu().numpy(), tasks, 1, 5)
            replay = (time.perf_counter() - t0) * 1e3
            record["scorer_ms"][f"tasks_{tasks}_1shot_5way"] = {
                "ms": scorer_ms(scorer, t, utts, counts, key), "replay_host_ms": replay}
        gathered = t.new_empty(t.shape)
        one = torch.ones(1, device=DEVICE)
        record["collective_ms"] = {
            "all_gather_table": collective_ms(dist.all_gather_into_tensor, gathered, t),
            "all_reduce_scalar": collective_ms(dist.all_reduce, one)}
    record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(record)
    return out


def run_dp_slice(sliced: dict, seed: int, card: str) -> dict:
    """Data-parallel training at world size 1 through NCCL:
    ``make_dp_classifier_train_step`` for TRAIN_STEPS steps at batch 32 on
    config #1 at full width (per step B1 1, B4 1, B5 1, B7 3 + 3), losses
    finite and falling; one DP step held against the single-device step on
    the same draw (``compare_steps``); ``fit(dp="on")`` at world 1 warns
    and trains unsharded; the DP step's ms and utt/s against the
    single-device step's, in turns."""
    torch.cuda.reset_peak_memory_stats()
    host = sliced["host"]
    cfg = train_config(seed)
    store = device_store_for(cfg, host, DEVICE)
    n = len(host.label_names)
    model = SpeakerClassifier(cfg.encoder, n, device=DEVICE)
    weights = from_flax(random_flax_variables(cfg.encoder, n, seed), cfg.encoder)
    n_mid = len(cfg.encoder.filter_multipliers) - 1
    S = TRAIN_STEPS
    record = {"phase": "dp_slice", "config": cfg.name, "world_size": 1, "backend": PG_BACKEND,
              "batch": TRAIN_BATCH, "steps": S, "card": card}
    with process_group() as mesh:
        model.load_state_dict(weights)
        step, loss_fn = data_parallel.make_dp_classifier_train_step(model, cfg, mesh)
        state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
        gen = torch.Generator(device=DEVICE)
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        for i in range(S):
            gen.manual_seed(seed * 1_000_003 + i)
            state, m = step(state, store, gen)
            losses.append(m["loss"])
        launches = read_counts()
        seconds = time.perf_counter() - t0
        expect_launches("dp_slice", launches, gather_whiten=S, conv_block0_train=S,
                        conv_block0_train_bwd=S, pool_fwd=n_mid * S, route_bwd=n_mid * S)
        first, last = losses_falling("dp_slice", losses)

        runs = []
        for dp in (True, False):
            model.load_state_dict(weights)
            make = (data_parallel.make_dp_classifier_train_step if dp
                    else steps.make_classifier_train_step)
            one = make(model, cfg, mesh)[0] if dp else make(model, cfg)[0]
            st = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
            m = one(st, store, torch.Generator(device=DEVICE).manual_seed(seed + 7))[1]
            runs.append((float(m["loss"]), step_grads(model)))
        held = compare_steps(runs, True, ("dp", "single"))

        turns = []
        for dp in (False, True, True, False):
            model.load_state_dict(weights)
            one = (data_parallel.make_dp_classifier_train_step(model, cfg, mesh)[0] if dp
                   else steps.make_classifier_train_step(model, cfg)[0])
            st = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
            g = torch.Generator(device=DEVICE)
            for i in range(3):  # warm-up
                one(st, store, g.manual_seed(i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DP_TIMING_STEPS):
                one(st, store, g.manual_seed(seed + i))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / DP_TIMING_STEPS
            turns.append({"step": "dp" if dp else "single", "ms": ms,
                          "utt_per_s": TRAIN_BATCH * 1e3 / ms})

        fit_cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_steps=DP_FIT_STEPS,
                                                        evaluate_every=DP_FIT_STEPS))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            history, fit_losses, fit_launches, eval_launches, fit_seconds = counted_fit(
                fit_cfg, host, dp="on")
        said = [str(w.message) for w in caught if "single attached device" in str(w.message)]
        if not said:
            raise AssertionError("fit(dp='on') at world size 1 did not warn")
        F = DP_FIT_STEPS
        expect_launches("dp_fit", fit_launches, gather_whiten=F, conv_block0_train=F,
                        conv_block0_train_bwd=F, pool_fwd=n_mid * F, route_bwd=n_mid * F)
        # the evaluation embeds through the model's own forward: B1 only
        expect_launches("dp_fit evaluation", eval_launches,
                        gather_whiten=-(-len(host.labels) // 256))
        losses_falling("dp_fit", fit_losses, falling=False)
    mean = {k: float(np.mean([t["ms"] for t in turns if t["step"] == k]))
            for k in ("dp", "single")}
    record.update(launches=launches, losses=torch.stack(losses).float().cpu().tolist(),
                  loss_first5_mean=first, loss_last5_mean=last, seconds=seconds,
                  dp_vs_single_step=held, step_turns=turns, step_ms=mean,
                  dp_over_single=mean["dp"] / mean["single"],
                  fit_dp_on={"warning": said[0], "steps": F, "launches": fit_launches,
                             "eval_launches": eval_launches, "final_record": history[-1],
                             "seconds": fit_seconds},
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(record)
    return {"dp_train": launches, "dp_fit": fit_launches}


# ---------------------------------------------------------------------------
# mesh_slice: sequence, tensor and pipeline parallelism over MESH_WORLD ranks
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_counts(device) -> dict:
    """The launch counters (``read_counts`` without its CUDA call off the card)."""
    _sync(device)
    return {name: getattr(wrapper, counter) for name, (wrapper, counter, _, _) in KERNELS.items()}


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def hold(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def mesh_timed(fn, device, calls: int) -> dict:
    """Host ms of one call of ``fn`` (one warm-up, then ``calls`` calls, the
    card synchronized around them) and what a call staged through the host
    (``parallel/comm.STAGED``)."""
    fn()
    _sync(device)
    comm.reset_staged()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / calls
    return {"ms": ms, "staged_bytes": comm.STAGED["bytes"] / calls,
            "staged_calls": comm.STAGED["calls"] / calls,
            "staged_ms": comm.STAGED["seconds"] * 1e3 / calls}


def mesh_classifier(cfg, n: int, seed: int, device):
    """Config ``cfg``'s classifier with the seed's random flax weights."""
    model = SpeakerClassifier(cfg.encoder, n, device=device)
    model.load_state_dict(from_flax(random_flax_variables(cfg.encoder, n, seed), cfg.encoder))
    return model


def f32_config(cfg, dropout: float = None):
    enc = dataclasses.replace(cfg.encoder, compute_dtype="float32",
                              dropout=cfg.encoder.dropout if dropout is None else dropout)
    return cfg.replace(encoder=enc)


def mesh_configs() -> tuple:
    """mesh_slice's configs #3 and #1, at full width."""
    return dilated_4khz(), classifier_baseline()


def mesh_plan(seed: int) -> dict:
    """What every rank of mesh_slice runs, from this module's constants and
    configs (a rank cannot see a caller's changes to them)."""
    config3, config1 = mesh_configs()
    return {"seed": seed, "device": DEVICE, "world": MESH_WORLD,
            "data_seq": dict(MESH_DATA_SEQ), "data_model": dict(MESH_DATA_MODEL),
            "config3": config3, "config1": config1,
            "sp_batch": MESH_SP_BATCH, "tp_rows": MESH_TP_ROWS, "mlp": MESH_MLP, "pp": MESH_PP,
            "ppr_eval": MESH_PPR_EVAL, "ppr_train": MESH_PPR_TRAIN, "store": dict(MESH_STORE),
            "calls": MESH_CALLS, "child_setup": MESH_CHILD_SETUP}


def mesh_sp(plan: dict, sizes: dict) -> dict:
    """``make_sharded_embed_fn`` on config #3 in f32 (time over ``seq``)
    against the single-device ``ConvEncoder`` eval forward."""
    dev, seed = plan["device"], plan["seed"]
    cfg = f32_config(plan["config3"])
    mesh = make_mesh(sizes)
    sax = comm.axis(mesh, "seq")
    enc = mesh_classifier(cfg, 8, seed, dev).encoder
    T, B = cfg.data.model_length, plan["sp_batch"]
    x = torch.as_tensor(np.random.default_rng(seed + 21).standard_normal((B, T, 1)),
                        dtype=torch.float32).to(dev)
    t_loc = T // sax.size
    x_local = x[:, sax.index * t_loc:(sax.index + 1) * t_loc].contiguous()
    embed = halo_conv.make_sharded_embed_fn(cfg.encoder, mesh, "seq")

    def run():
        with torch.no_grad():
            return embed(enc, x_local)

    reset_counts()
    got = run()
    launches = mesh_counts(dev)
    with torch.no_grad():
        want = enc(x)
    rel = max_rel(got, want)
    hold(rel <= MESH_SP_RTOL, f"sp: sharded embed against the dense forward {rel}")
    return {"config": cfg.name, "batch": B, "T": T, "seq": sax.size, "rel_err": rel,
            "tolerance": MESH_SP_RTOL, "launches": launches,
            **mesh_timed(run, dev, plan["calls"])}


def mesh_step_rows(store, cfg, gen_seed: int, n_data: int, device) -> tuple:
    """The data × seq step's draws, every data row's, concatenated: the
    single-device full batch."""
    xs, ys = [], []
    for d in range(n_data):
        g = steps.rank_generator(torch.Generator(device=device).manual_seed(gen_seed), d)
        idx = sampling.sample_classifier_batch(g, store.labels.shape[0],
                                               cfg.train.batch_size // n_data, device)
        xs.append(fetch_batch(store, idx, cfg, g, cfg.data.stochastic))
        ys.append(store.labels[idx])
    return torch.cat(xs), torch.cat(ys)


def float_buffers(model) -> dict:
    return {k: b.detach().double().flatten().clone() for k, b in model.named_buffers()
            if b.is_floating_point()}


def cosines(a: dict, b: dict) -> dict:
    return {k: float(torch.nn.functional.cosine_similarity(a[k], b[k], dim=0)) for k in a}


def mesh_dp_sp(plan: dict, sizes: dict, host) -> dict:
    """One config #3 step at its batch over ``{data, seq}`` at dropout 0 (B1
    on the decimated store, counted), held on the mesh's first rank against
    the single-device full-batch step (autograd blocks, f32) on the same
    draws; one step at the config's dropout reported; the step's ms."""
    dev, seed = plan["device"], plan["seed"]
    cfg = f32_config(plan["config3"], dropout=0.0)
    mesh = make_mesh(sizes)
    dax, sax = comm.axis(mesh, "data"), comm.axis(mesh, "seq")
    store = device_store_for(cfg, host, dev)
    n = len(host.label_names)
    model = mesh_classifier(cfg, n, seed, dev)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    step, _ = dp_sp.make_dp_sp_classifier_train_step(model, cfg, mesh)
    state = init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    reset_counts()
    m = step(state, store, torch.Generator(device=dev).manual_seed(seed + 31))[1]
    launches = mesh_counts(dev)
    loss, grads, buffers = float(m["loss"]), step_grads(model), float_buffers(model)
    out = {"config": cfg.name, "batch": cfg.train.batch_size, "mesh": sizes, "loss": loss,
           "launches": launches}
    if dax.index == 0 and sax.index == 0:
        ref = mesh_classifier(cfg, n, seed, dev)
        ref.load_state_dict(snapshot)
        ref_cfg = cfg.replace(train=dataclasses.replace(cfg.train, use_fused_block0=False,
                                                        use_fused_blockn=False))
        x, y = mesh_step_rows(store, cfg, seed + 31, dax.size, dev)
        ref_state = init_state(ref, cfg.train.clipnorm, cfg.train.learning_rate)
        rm = steps.train_on_batch(ref_state, x, y, None, steps.classifier_loss_fn(ref, ref_cfg))[1]
        ref_loss = float(rm["loss"])
        g_cos, b_cos = cosines(grads, step_grads(ref)), cosines(buffers, float_buffers(ref))
        rel = abs(loss - ref_loss) / abs(ref_loss)
        worst_g, worst_b = min(g_cos, key=g_cos.get), min(b_cos, key=b_cos.get)
        hold(rel <= MESH_LOSS_RTOL and g_cos[worst_g] >= MESH_MIN_COSINE
             and b_cos[worst_b] >= MESH_MIN_COSINE,
             f"dp_sp against the single-device step: loss {loss} vs {ref_loss}, gradient "
             f"cosine {g_cos[worst_g]} at {worst_g}, statistic cosine {b_cos[worst_b]} at "
             f"{worst_b}")
        out["single_device"] = {
            "loss": ref_loss, "loss_rel_diff": rel, "loss_rtol": MESH_LOSS_RTOL,
            "min_grad_cosine": g_cos[worst_g], "min_grad_at": worst_g,
            "min_stat_cosine": b_cos[worst_b], "min_stat_at": worst_b,
            "cosine_tolerance": MESH_MIN_COSINE, "blocks": "autograd (jnp), f32"}
    gen = torch.Generator(device=dev)
    out.update(mesh_timed(lambda: step(state, store, gen.manual_seed(seed + 32)), dev,
                          plan["calls"]))
    drop_cfg = f32_config(plan["config3"])
    drop = mesh_classifier(drop_cfg, n, seed, dev)
    drop_step, _ = dp_sp.make_dp_sp_classifier_train_step(drop, drop_cfg, mesh)
    dm = drop_step(init_state(drop, drop_cfg.train.clipnorm, drop_cfg.train.learning_rate),
                   store, torch.Generator(device=dev).manual_seed(seed + 33))[1]
    out["at_config_dropout"] = {"dropout": drop_cfg.encoder.dropout, "loss": float(dm["loss"])}
    hold(np.isfinite(out["at_config_dropout"]["loss"]), "dp_sp: non-finite loss at dropout")
    return out


def mesh_tp(plan: dict, sizes: dict) -> dict:
    """``make_tp_encoder_embed_fn`` on config #1 in bf16 over ``{data,
    model}`` (B2 and B8 counted) against the f32 Dense on ``fast_trunk``'s
    output, and ``make_tp_mlp`` against the dense product."""
    dev, seed = plan["device"], plan["seed"]
    cfg = plan["config1"]
    mesh = make_mesh(sizes)
    dax = comm.axis(mesh, "data")
    enc = mesh_classifier(cfg, 8, seed, dev).encoder
    T, rows = cfg.data.model_length, plan["tp_rows"]
    x = torch.as_tensor(np.random.default_rng(seed + 41).standard_normal(
        (dax.size * rows, T, 1)), dtype=torch.float32).to(dev)
    x_local = x[dax.index * rows:(dax.index + 1) * rows].contiguous()
    fn = tensor_parallel.make_tp_encoder_embed_fn(cfg.encoder, mesh)
    reset_counts()
    emb = fn(enc, x_local)
    launches = mesh_counts(dev)
    with torch.inference_mode(), halo_conv.full_f32():
        h = fast_trunk(enc, x_local).amax(dim=1).float()
        want = h @ enc.embed.weight.t().float() + enc.embed.bias.float()
        served = fast_embed(enc, x_local)
    rel = max_rel(emb, want)
    hold(rel <= MESH_TP_RTOL, f"tp: the embedding against the f32 head on the trunk {rel}")
    B, D, H, F_ = plan["mlp"]
    r = np.random.default_rng(seed + 42)
    w = [torch.as_tensor(r.standard_normal(s) * (s[0] ** -0.5 if len(s) > 1 else 0.1),
                         dtype=torch.float32).to(dev)
         for s in ((B, D), (D, H), (H,), (H, F_), (F_,))]
    mlp = tensor_parallel.make_tp_mlp(mesh, "model")
    with torch.no_grad(), halo_conv.full_f32():
        y = mlp(*w)
        dense = torch.relu(w[0] @ w[1] + w[2]) @ w[3] + w[4]
    mlp_rel = max_rel(y, dense)
    hold(mlp_rel <= MESH_TP_RTOL, f"tp: the MLP against the dense product {mlp_rel}")
    with torch.no_grad():
        mlp_t = mesh_timed(lambda: mlp(*w), dev, plan["calls"])
    return {"config": cfg.name, "dtype": cfg.encoder.compute_dtype, "mesh": sizes,
            "rows": rows, "rel_err": rel, "tolerance": MESH_TP_RTOL,
            "rel_to_served_bf16_head": max_rel(emb, served), "launches": launches,
            "mlp": {"shape": [B, D, H, F_], "rel_err": mlp_rel, **mlp_t},
            **mesh_timed(lambda: fn(enc, x_local), dev, plan["calls"])}


def _mesh_stage(params, x):
    w, b = params
    return torch.relu(x @ w + b)


def _mesh_mse(out, y):
    return torch.mean((out - y) ** 2)


def mesh_pp(plan: dict, stages: int) -> dict:
    """``make_gpipe_fn`` and ``make_gpipe_train_step`` with every rank a
    stage (dense relu stages) against the stages applied in turn."""
    dev, seed = plan["device"], plan["seed"]
    D, mb, M = plan["pp"]
    mesh = make_mesh({"pp": stages})
    me = comm.axis(mesh, "pp").index
    r = np.random.default_rng(seed + 51)
    f32 = dict(dtype=torch.float32, device=dev)
    ws = torch.as_tensor(r.standard_normal((stages, D, D)) * D ** -0.5, **f32)
    bs = torch.as_tensor(r.standard_normal((stages, D)) * 0.1, **f32)
    x = torch.as_tensor(r.standard_normal((M, mb, D)), **f32)
    tgt = torch.as_tensor(r.standard_normal((M, mb, D)), **f32)
    mine = (ws[me:me + 1], bs[me:me + 1])
    fn = pipeline_parallel.make_gpipe_fn(mesh, _mesh_stage, M)
    step = pipeline_parallel.make_gpipe_train_step(mesh, _mesh_stage, _mesh_mse, M)
    with halo_conv.full_f32():
        with torch.no_grad():
            y = fn(mine, x)
        loss, grads = step(mine, x, tgt)
        wr, br = ws.clone().requires_grad_(), bs.clone().requires_grad_()
        seq = x
        for s in range(stages):
            seq = _mesh_stage((wr[s], br[s]), seq)
        ref_loss = _mesh_mse(seq, tgt)
        ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    rel = {"out": max_rel(y, seq), "loss": abs(float(loss) - ref_loss) / ref_loss,
           "grad_w": max_rel(grads[0][0], wr.grad[me]), "grad_b": max_rel(grads[1][0], br.grad[me])}
    worst = max(rel, key=rel.get)
    hold(rel[worst] <= MESH_PP_RTOL, f"pp: {worst} against the sequential stages {rel[worst]}")
    with halo_conv.full_f32():
        with torch.no_grad():
            fwd_t = mesh_timed(lambda: fn(mine, x), dev, plan["calls"])
        step_t = mesh_timed(lambda: step(mine, x, tgt), dev, plan["calls"])
    return {"stages": stages, "D": D, "mb": mb, "n_micro": M, "rel_err": rel,
            "tolerance": MESH_PP_RTOL, "out_shape": list(y.shape), "loss": float(loss),
            "forward": fwd_t, "train_step": step_t}


def grads_row(cfg, model, pack) -> torch.Tensor:
    """An encoder's gradients in the pipeline's flat row: a module holding
    them as its parameters and zeros as its statistics, packed."""
    g = ConvEncoder(cfg.encoder, device=next(model.parameters()).device)
    sd = {k: torch.zeros_like(v) for k, v in g.state_dict().items()}
    sd.update({k: p.grad for k, p in model.named_parameters()})
    g.load_state_dict(sd)
    return pack(g)


def mesh_pp_real(plan: dict, rank: int) -> dict:
    """The two-stage real-encoder pipeline on a ``{pp 2}`` mesh of ranks 0
    and 1 (every rank builds the mesh): eval on config #1 in bf16 (B2 on
    stage 0, B8 on stage 1, counted) against ``fast_embed`` per microbatch;
    a train step in f32 against sequential autograd over the microbatches,
    and ``apply_stats`` against the chained train-mode forwards."""
    dev, seed = plan["device"], plan["seed"]
    mesh = make_mesh({"pp": 2})
    if rank >= 2:
        return {}
    cfg = plan["config1"]
    T = cfg.data.model_length
    r = np.random.default_rng(seed + 61)
    f32 = dict(dtype=torch.float32, device=dev)
    mb, M = plan["ppr_eval"]
    enc = mesh_classifier(cfg, 8, seed, dev).encoder
    x = torch.as_tensor(r.standard_normal((M, mb, T, 1)), **f32)
    fn, pack = pipeline_parallel.make_gpipe_real_encoder_fn(cfg.encoder, mesh, enc, mb, T, M)
    flat = pack(enc)
    reset_counts()
    with torch.no_grad():
        out = fn(flat, x)
    eval_launches = mesh_counts(dev)
    want = torch.stack([fast_embed(enc, x[t]) for t in range(M)])
    eval_rel = max_rel(out, want)
    hold(eval_rel <= MESH_PPR_EVAL_RTOL, f"pp-real eval against fast_embed {eval_rel}")
    with torch.no_grad():
        eval_t = mesh_timed(lambda: fn(flat, x), dev, plan["calls"])

    cfg32 = f32_config(cfg, dropout=0.0)  # the pipeline's train blocks drop nothing
    mb, M = plan["ppr_train"]
    enc = mesh_classifier(cfg32, 8, seed, dev).encoder
    snapshot = {k: v.clone() for k, v in enc.state_dict().items()}
    x = torch.as_tensor(r.standard_normal((M, mb, T, 1)), **f32)
    y = torch.as_tensor(r.standard_normal((M, mb, cfg.encoder.embedding_dim)), **f32)
    step, pack, apply_stats = pipeline_parallel.make_gpipe_real_train_step(
        cfg32.encoder, mesh, enc, mb, T, M, _mesh_mse)
    flat = pack(enc)
    reset_counts()
    loss, grads, stats = step(flat, x, y)
    train_launches = mesh_counts(dev)
    new = comm.tree_flatten(apply_stats(enc, stats))[0]
    ref = ConvEncoder(cfg32.encoder, device=dev)
    ref.load_state_dict(snapshot)
    ref.train()
    ref_loss = _mesh_mse(torch.stack([ref(x[t]) for t in range(M)]), y)
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    chained = [t for blk in ref.blocks for t in (blk.bn.running_mean, blk.bn.running_var)]
    rel = {"loss": abs(float(loss) - ref_loss) / ref_loss,
           "grads": max_rel(grads, grads_row(cfg32, ref, pack)),
           "stats": max(max_rel(a, b) for a, b in zip(new, chained))}
    hold(rel["loss"] <= MESH_LOSS_RTOL and rel["grads"] <= MESH_PPR_GRAD_RTOL
         and rel["stats"] <= MESH_PPR_STATS_RTOL, f"pp-real train against sequential {rel}")
    train_t = mesh_timed(lambda: step(flat, x, y), dev, plan["calls"])
    return {"stage": rank, "config": cfg.name,
            "eval": {"dtype": cfg.encoder.compute_dtype, "mb": plan["ppr_eval"][0],
                     "n_micro": plan["ppr_eval"][1], "rel_err": eval_rel,
                     "equal": bool(torch.equal(out, want)), "tolerance": MESH_PPR_EVAL_RTOL,
                     "launches": eval_launches, **eval_t},
            "train": {"dtype": "float32", "mb": mb, "n_micro": M, "loss": float(loss),
                      "rel_err": rel, "tolerances": {
                          "loss": MESH_LOSS_RTOL, "grads": MESH_PPR_GRAD_RTOL,
                          "stats": MESH_PPR_STATS_RTOL},
                      "launches": train_launches, **train_t}}


def mesh_programs(rank: int, world: int, plan: dict) -> dict:
    """Every program of mesh_slice on this rank of the world."""
    dev = plan["device"]
    host = synthetic_store(plan["seed"], **plan["store"])
    out = {"rank": rank}
    for name, fn in (("sp", lambda: mesh_sp(plan, plan["data_seq"])),
                     ("dp_sp", lambda: mesh_dp_sp(plan, plan["data_seq"], host)),
                     ("tp", lambda: mesh_tp(plan, plan["data_model"])),
                     ("pp", lambda: mesh_pp(plan, world)),
                     ("pp_real", lambda: mesh_pp_real(plan, rank))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fields = dryrun.dryrun_rank(rank, world, dev)
    out["dryrun"] = {"fields": fields, "line": dryrun.line(world, fields),
                     "seconds": time.perf_counter() - t0}
    if rank == 0:
        print(out["dryrun"]["line"], flush=True)
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if torch.device(dev).type == "cuda" else 0.0)
    return out


def _mesh_rank(rank: int, world: int, rendezvous: str, plan: dict, out_dir: str) -> None:
    """One rank of mesh_slice: its stdout and stderr to ``rank<r>.log``,
    the gloo group joined with its tensors on the card, every program run,
    the results to ``rank<r>.pt``."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    try:
        if plan["child_setup"] is not None:
            plan["child_setup"]()
        torch.set_num_threads(1)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        distributed.initialize(rendezvous, world, rank, device=plan["device"], backend="gloo")
        try:
            torch.save(mesh_programs(rank, world, plan), os.path.join(out_dir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


def spawn_mesh(plan: dict, out_dir: str) -> list:
    """MESH_WORLD ranks of ``_mesh_rank`` on a file rendezvous in
    ``out_dir``; every process stopped on return → their results."""
    world = plan["world"]
    try:
        distributed.spawn(_mesh_rank, world, (world, f"file://{out_dir}/rendezvous", plan,
                                              out_dir), MESH_TIMEOUT)
    except BaseException:
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.log")
            if os.path.exists(path):
                print(f"--- mesh_slice rank {r} ---\n{open(path).read()[-4000:]}",
                      file=sys.stderr)
        raise
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_mesh_slice(seed: int, card: str) -> dict:
    """Sequence, tensor and pipeline parallelism on the card: first each
    program whose mesh admits one rank, in-process at world size 1 through
    PG_BACKEND (NCCL: the device tensors go to the collectives as they are),
    held against its single-device counterpart, and the real-encoder
    pipeline's refusal at pp 1; then MESH_WORLD ranks on the one card in a
    gloo group (file rendezvous under ``build/``, destroyed after the
    phase), each running sp, dp_sp, tp, pp, pp-real and the dry run, held
    as the functions above say; their stdout gathered, the dry run's line
    printed from rank 0's. Times are one card shared by the ranks over host
    transport, not collective costs across cards."""
    plan = mesh_plan(seed)
    record = {"phase": "mesh_slice", "card": card, "world": plan["world"],
              "transport": f"gloo, host-staged: one card shared by {plan['world']} ranks; "
                           "not a collective cost across cards",
              "meshes": {"sp_dp_sp": plan["data_seq"], "tp": plan["data_model"],
                         "pp": {"pp": plan["world"]}, "pp_real": {"pp": 2}}}
    one = {"data": 1, "seq": 1}
    with process_group():
        host = synthetic_store(seed, **plan["store"])
        record["world_1"] = {
            "backend": PG_BACKEND, "sp": mesh_sp(plan, one), "dp_sp": mesh_dp_sp(plan, one, host),
            "tp": mesh_tp(plan, {"data": 1, "model": 1}), "pp": mesh_pp(plan, 1)}
        cfg = plan["config1"]
        try:
            pipeline_parallel.make_gpipe_real_encoder_fn(
                cfg.encoder, make_mesh({"pp": 1}), ConvEncoder(cfg.encoder, device=DEVICE), 2,
                cfg.data.model_length, 2)
        except ValueError as e:
            record["world_1"]["pp_real_refusal"] = str(e)
        else:
            raise AssertionError("the real-encoder pipeline ran at pp 1")
    torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh_slice")
    if os.path.isdir(out_dir):
        for name in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, name))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    results = spawn_mesh(plan, out_dir)
    record["seconds"] = time.perf_counter() - t0
    logs = [open(os.path.join(out_dir, f"rank{r}.log")).read() for r in range(plan["world"])]
    line = results[0]["dryrun"]["line"]
    hold(line in logs[0], "the dry run's line is not in rank 0's stdout")
    hold(all(r["dryrun"]["fields"] == results[0]["dryrun"]["fields"] for r in results),
         "the ranks' dry-run fields differ")
    n_mid = len(plan["config1"].encoder.filter_multipliers) - 1
    M = plan["ppr_eval"][1]
    for r in [{"rank": "at world 1", **record["world_1"]}, *results]:
        expect_launches(f"dp_sp rank {r['rank']}", r["dp_sp"]["launches"], gather_whiten=1)
        expect_launches(f"tp rank {r['rank']}", r["tp"]["launches"], conv_block0=1,
                        conv_blockn=n_mid)
        expect_launches(f"sp rank {r['rank']}", r["sp"]["launches"])
    expect_launches("pp-real stage 0", results[0]["pp_real"]["eval"]["launches"], conv_block0=M)
    expect_launches("pp-real stage 1", results[1]["pp_real"]["eval"]["launches"],
                    conv_blockn=n_mid * M)
    for r in results[:2]:
        expect_launches(f"pp-real train rank {r['rank']}", r["pp_real"]["train"]["launches"])
    hold(all(r["dp_sp"]["loss"] == results[0]["dp_sp"]["loss"] for r in results),
         "dp_sp: the ranks' losses differ")

    def summed(get) -> dict:
        parts = [get(r) for r in results if get(r) is not None]
        return {k: sum(p[k] for p in parts) for k in KERNELS}

    paths = {"sp_embed": summed(lambda r: r["sp"]["launches"]),
             "dp_sp_train": summed(lambda r: r["dp_sp"]["launches"]),
             "tp_embed": summed(lambda r: r["tp"]["launches"]),
             "pp_real_eval": summed(lambda r: r["pp_real"].get("eval", {}).get("launches")),
             "pp_real_train": summed(lambda r: r["pp_real"].get("train", {}).get("launches"))}
    print(line, flush=True)
    record.update(ranks=results, dryrun_line=line, launches=paths,
                  stdout_tail=[log[-2000:] for log in logs])
    emit(record)
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    started = time.perf_counter()
    STARTED[:] = [started]
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    # Stated, not inherited: every f32 conv and matmul here is full f32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    warm_workspaces()
    path, seconds, ptxas = _build.build()
    _build.library()
    emit({"phase": "build", "library": path.name, "seconds": seconds,
          "sources": [p.name for p in _build.sources()],
          "ptxas": [line.split(": ", 1)[-1] for line in ptxas.splitlines()
                    if "Used" in line or "spill" in line]})

    store, idx, offsets = bench_store(args.seed)
    params = block0_params(args.seed)
    checked = check_kernels(store, idx, offsets, params)
    checked_train = check_train_kernels(store, idx, offsets)
    sliced = run_slice(args.seed)
    sliced_int8 = run_int8_slice(sliced, args.seed)
    gate = run_fidelity_gate(store, offsets, sliced["model"], args.seed)
    trained = run_train_slice(sliced, args.seed)
    int8_trained = run_int8_train_slice(sliced, args.seed)
    recomputed = run_recompute_train_slice(sliced, args.seed)
    raw_trained = run_raw_store_slice(sliced, args.seed)
    times = run_timing(store, idx, offsets, params, checked["s0"], sliced["model"],
                       sliced["cfg"], gate["qvars"], args.seed, card)
    attributed = run_attribution(args.seed, card, times["b3_library"])
    train_times = run_train_timing(store, idx, offsets, trained, args.seed, card)
    sliced3 = run_slice(args.seed, dilated_4khz(), "dilated_slice", sliced["host"])
    sliced3_int8 = run_int8_slice(sliced3, args.seed, "dilated_int8_slice")
    gate3 = run_fidelity_gate(store, offsets, sliced3["model"], args.seed, hold=False,
                              phase="dilated_int8_fidelity", config="dilated_4khz")
    trained3 = run_train_slice(sliced3, args.seed, dilated_4khz(), "dilated_train_slice")
    run_dilated_timing(store, sliced3, gate3, trained3, args.seed, card)
    sliced3_launches = {"bf16": sliced3["launches"], "int8": sliced3_int8["launches"],
                        "train": trained3["launches"]}
    del store, sliced3, sliced3_int8, trained3
    torch.cuda.empty_cache()
    wgrad = run_wgrad_slice(card)
    raw, mel_idx, mel_offsets = mel_bench_store(args.seed)
    checked_mel = check_mel_kernels(raw, mel_idx, mel_offsets)
    mel = run_mel_slices(sliced["host"], args.seed)
    mel_gate = run_mel_fidelity(raw, mel_offsets, mel["model"], args.seed)
    mel_times = run_mel_timing(raw, mel_idx, mel_offsets, mel["model"], mel_gate["qvars"],
                               args.seed, card)
    del raw
    torch.cuda.empty_cache()
    asp = run_asp_slice(args.seed, card)
    ecapa_trained = run_ecapa_train_slice(args.seed, card)
    checked_siamese = check_siamese_kernels()
    siamese = run_siamese_slices(sliced["host"], args.seed)
    siamese_trained = run_siamese_train_slice(sliced["host"], args.seed)
    siamese_times = run_siamese_timing(siamese, siamese_trained, args.seed, card)
    mel_trained = run_mel_train_slice(sliced["host"], args.seed)
    run_mel_train_timing(mel_trained, args.seed, card)
    mel_train_launches = mel_trained["launches"]
    del mel_trained
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="voicemap_corpus_") as root:
        corpus = run_corpus_slice(root, args.seed, card)
        streamed = run_streaming_embed(root, args.seed)
    with tempfile.TemporaryDirectory(prefix="voicemap_protocol_") as root:
        cli = run_protocol_slice(root, args.seed, card)
    pod = run_pod_slice(sliced, siamese, gate, args.seed, card)
    dp_paths = run_dp_slice(sliced, args.seed, card)
    mesh_paths = run_mesh_slice(args.seed, card)
    for key in ("ms", "plain_ms", "bounds", "library_ms"):
        times[key].update(attributed[key])
        times[key].update(train_times[key])
        times[key].update(mel_times[key])
        times[key].update(siamese_times[key])
        times[key].update(asp[key])
        times[key].update(wgrad[key])
    checked["errors"].update(checked_train["errors"])
    checked["errors"].update(wgrad["errors"])
    checked["errors"].update(asp["errors"])
    checked["errors"].update(checked_mel["errors"])
    checked["errors"].update(checked_siamese["errors"])

    # Each entry's launches: the counts of the path runs above (phases slice,
    # int8_slice, train_slice, int8_train_slice, recompute_train_slice,
    # raw_store_slice, attribution, dilated_slice, dilated_int8_slice,
    # dilated_train_slice, mel_bf16_slice, mel_int8_slice, siamese_bf16_slice,
    # siamese_int8_slice, verification, score_support, siamese_train_slice,
    # mel_train_slice, corpus_slice's three fits, streaming_embed's three
    # tables, protocol_slice's CLI commands, pod_slice's three pod_evaluate
    # paths, dp_slice's DP steps and fit(dp="on"), mesh_slice's programs, summed
    # over its ranks, ecapa_embed and ecapa_train), set to 0 just before each
    # run and read just after; ASP's, also the asp_kernels phase's checks;
    # conv_wgrad's, also the wgrad_kernels phase's;
    # for the kernels no other path runs (B2's, B4's and B5's f32 GEMM), the
    # count of the check phase that ran them. On the mel paths the DFT route
    # launched nothing, so B6's count there is the FFT kernel's; ECAPA's
    # training step launches the DFT route.
    paths = {"kernels": checked["launches"], "train_kernels": checked_train["launches"],
             "mel_kernels": checked_mel["launches"],
             "bf16": sliced["launches"], "int8": sliced_int8["launches"],
             "attribution": attributed["launches"],
             "train": trained["launches"], "int8_train": int8_trained["launches"],
             "recompute_train": recomputed["launches"], "raw_train": raw_trained["launches"],
             "dilated_bf16": sliced3_launches["bf16"],
             "dilated_int8": sliced3_launches["int8"], "dilated_train": sliced3_launches["train"],
             "mel_bf16": mel["mel_bf16"],
             "mel_int8": mel["mel_int8"], "siamese_bf16": siamese["siamese_bf16"],
             "siamese_int8": siamese["siamese_int8"], "verification": siamese["verification"],
             "score_support": siamese["score_support"],
             "siamese_train": siamese_trained["launches"],
             "mel_train": mel_train_launches, **corpus, **streamed, **cli, **pod,
             **dp_paths, **mesh_paths, **asp["launches"], **ecapa_trained,
             **wgrad["launches"]}
    train_paths = ("train", "int8_train", "raw_train", "dilated_train", "siamese_train",
                   "corpus_device", "corpus_streaming", "corpus_siamese", "cli_train",
                   "cli_siamese_train", "dp_train", "dp_fit")
    cli_int8 = ("cli_protocol_int8", "cli_int8_gate", "cli_embed")
    entries = (("gather_whiten", "gather_whiten",
                ("bf16", "int8", "train", "int8_train", "recompute_train", "raw_train",
                 "dilated_bf16", "dilated_int8", "dilated_train",
                 "mel_bf16", "mel_int8", "siamese_bf16", "siamese_int8", "siamese_train",
                 "mel_train", "corpus_device", "cli_train", "cli_protocol_bf16", *cli_int8,
                 "cli_sweep", "cli_siamese_train", "cli_siamese_protocol", "cli_visualize",
                 "pod_bf16", "pod_int8", "pod_siamese", "dp_train", "dp_fit", "dp_sp_train",
                 "ecapa_train")),
               ("conv_block0", "conv_block0", ("bf16", "dilated_bf16", "siamese_bf16",
                                               "streaming_bf16", "cli_sweep", "tp_embed",
                                               "pp_real_eval", "sp_embed", "pp_real_train")),
               ("conv_block0_int8", "conv_block0", ("int8", "dilated_int8", "siamese_int8",
                                                    "streaming_int8", *cli_int8, "pod_int8")),
               ("conv_block0_f32", "conv_block0_f32", ("kernels",)),
               ("quant_block", "quant_block", ("int8", "dilated_int8", "siamese_int8",
                                               "streaming_int8", *cli_int8, "pod_int8")),
               ("conv_block0_train", "conv_block0_train", (*train_paths, "recompute_train")),
               ("conv_block0_train_bwd", "conv_block0_train_bwd",
                (*train_paths, "recompute_train")),
               ("conv_block0_train_f32", "conv_block0_train_f32", ("train_kernels",)),
               ("conv_block0_train_bwd_f32", "conv_block0_train_bwd_f32", ("train_kernels",)),
               ("pool_fwd", "pool_fwd", train_paths),
               ("route_bwd", "route_bwd", train_paths),
               ("log_mel", "log_mel", ("mel_bf16", "mel_int8", "mel_train",
                                       "streaming_mel", "ecapa_train")),
               ("log_mel_dft", "log_mel_dft", ("mel_kernels", "ecapa_train")),
               ("weighted_l1", "weighted_l1",
                ("siamese_bf16", "siamese_int8", "verification", "score_support",
                 "cli_siamese_train", "cli_siamese_protocol", "pod_siamese")),
               ("conv_blockn", "conv_blockn", ("bf16", "dilated_bf16", "siamese_bf16",
                                               "streaming_bf16", "cli_sweep",
                                               "recompute_train", "tp_embed", "pp_real_eval",
                                               "sp_embed", "pp_real_train")),
               ("quant_block_stage", "quant_block_stage", ("attribution",)),
               ("quant_block_train", "quant_block_train", ("int8_train",)),
               ("pool_fwd_idx", "pool_fwd_idx", ("recompute_train",)),
               ("route_bwd_idx", "route_bwd_idx", ("recompute_train",)),
               ("bn_apply", "bn_apply", (*train_paths, "recompute_train")),
               ("bn_grad", "bn_grad", (*train_paths, "recompute_train")),
               ("asp_stats", "asp_stats", ("asp_kernels", "ecapa_embed", "ecapa_train")),
               ("asp_global", "asp_global", ("asp_kernels", "ecapa_embed", "ecapa_train")),
               ("asp_bwd", "asp_bwd", ("asp_kernels", "ecapa_train")),
               ("conv_wgrad", "conv_wgrad", ("wgrad_kernels", "dilated_train", "train")))
    emit({"phase": "total", "seconds": time.perf_counter() - started, "card": card})
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[kernel][2],
         "replaces": KERNELS[kernel][3],
         "launches": sum(paths[p][kernel] for p in on),
         "launches_by_path": {p: paths[p][kernel] for p in on},
         "max_abs_err": checked["errors"][name], "ms": times["ms"][name],
         "plain_ms": times["plain_ms"][name], **times["bounds"][name],
         "library_ms": times["library_ms"][name]}
        for name, kernel, on in entries
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
