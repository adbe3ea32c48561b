"""One-utterance speaker identification, batch 1, arriving at a fixed rate.

Requests are due every ``1 / rate_per_s`` seconds (an open loop: a slow
request delays the ones behind it) and are answered one at a time, in
order, by one server. A request is a query of ``query_seconds`` of int16
audio in host memory, cycled from a pool of ``query_pool`` made from the
seed. It is served by a thin sequence of the program's calls:
``train.steps.host_to_device`` → ``train.steps.preprocess_fragments`` (÷
32768, stride decimation, whitening) → ``models.fast_infer.fast_embed`` →
``eval.nshot.classifier_nshot_predictions`` against an enrolled table → the
predicted speaker in host memory. Each is timed on the host's clock from
the moment it was due to that answer. The enrolled table holds ``support``
utterances of every speaker of the store, embedded in set-up by
``eval.nshot.embed_rows``.

Traffic parameters: ``store``, ``support``, ``query_pool``,
``query_seconds``, ``rate_per_s``, ``warm_requests`` (served back to back in
set-up), ``check_share`` and ``check_requests`` (a share of the requests,
drawn from the seed before the window, keeps its embedding; after it, that
many of them, drawn from the seed, are compared with the reference),
``trace_seconds``.
"""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models import fast_infer, quant_infer
from voicemap_tpu_torch.train import steps

from .. import data, program
from ..reference import load as load_reference
from . import Context, free

MAX_REQUESTS = 1_000_000  # requests a window can keep an embedding of
# SPIN: the server waits for a request's due time by spinning on the clock.
# Sleeping between requests let the core and the card settle, and a sleeping
# loop's p95 at 300/s read 3.7-31.9 ms against 2.44-2.48 spinning (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md).


class Job:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.traffic
        self.spec = data.StoreSpec.of(t["store"])
        self.support = int(t["support"])
        self.latencies, self.served = [], []
        self.keep = torch.rand(MAX_REQUESTS, generator=data.cpu_generator(ctx.seed, "keep"))
        self.keep = (self.keep < float(t["check_share"])).tolist()

    def set_up(self) -> None:
        ctx, t = self.ctx, self.ctx.traffic
        dev = ctx.device
        self.cfg = program.experiment_config(ctx.config)
        store = program.device_store(self.spec, ctx.seed, self.cfg.data.downsampling, dev)
        self.model = program.classifier(self.cfg, ctx.config, self.spec.speakers, ctx.seed, dev)
        self.qvars = (quant_infer.quantize_from_store(self.model, self.cfg, store)
                      if ctx.variant == "int8" else None)
        self.enrolled = self.support_rows()
        rows = self.enrolled.flatten().to(device=dev, dtype=torch.int32)
        with record_function("portbench.enrol"):
            self.table = nshot.embed_rows(self.model, store, self.cfg, rows,
                                          batch_size=rows.shape[0], fast=True, qvars=self.qvars)
        del store
        k, n = self.enrolled.shape
        self.support_idx = torch.arange(k * n, device=dev).reshape(1, k, n)
        self.query_idx = torch.tensor([k * n], device=dev)
        audio, _ = data.query_pool(self.spec, ctx.seed, int(t["query_pool"]),
                                   float(t["query_seconds"]), dev)
        self.pool = audio.cpu()  # the queries wait in host memory
        del audio
        free(dev)
        for _ in range(int(t["warm_requests"])):
            self.unit(time.perf_counter())
        self.latencies, self.served = [], []

    def support_rows(self) -> torch.Tensor:
        """``(speakers, support)`` store rows enrolled, drawn from the seed."""
        counts = data.speaker_counts(self.spec)
        starts = torch.cumsum(counts, 0) - counts
        gen = data.cpu_generator(self.ctx.seed, "support")
        return torch.stack([starts[s] + torch.randperm(int(counts[s]), generator=gen)[:self.support]
                            for s in range(self.spec.speakers)])

    def serve(self, query: torch.Tensor):
        """One request → (the query's embedding on the device, the predicted
        speaker id in host memory)."""
        x = steps.preprocess_fragments(steps.host_to_device(query, self.ctx.device), self.cfg)
        if self.qvars is None:
            e = fast_infer.fast_embed(self.model.encoder, x)
        else:
            e = quant_infer.quant_embed(self.model.encoder, self.qvars, x)
        pred = nshot.classifier_nshot_predictions(torch.cat([self.table, e]), self.query_idx,
                                                  self.support_idx)
        return e, int(pred.item())

    def unit(self, due: float) -> None:
        """Serve the next request, due at ``due`` on the host's clock."""
        i = len(self.served) % self.pool.shape[0]
        query = self.pool[i:i + 1]
        with record_function("portbench.request"):
            e, speaker = self.serve(query)
        self.latencies.append(time.perf_counter() - due)
        j = len(self.served)
        self.served.append((i, e if j < MAX_REQUESTS and self.keep[j] else None, speaker))

    def window(self, seconds: float) -> float:
        """Every request due in ``[0, seconds)``, each answered as soon as it is
        due and the one before it is answered → the seconds to the last answer."""
        gap = 1.0 / float(self.ctx.traffic["rate_per_s"])
        t0 = time.perf_counter()
        for k in range(math.ceil(seconds / gap)):
            due = t0 + k * gap
            while time.perf_counter() < due:  # spun, not slept: see SPIN
                pass
            self.unit(due)
        return time.perf_counter() - t0

    def end_to_end(self, window_s: float) -> dict:
        lat = sorted(self.latencies)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        return {"request_p95_ms": p95 * 1e3}

    def work(self) -> dict:
        return {"attempted": len(self.served), "failed": 0, "requests": len(self.served)}

    def release(self) -> None:
        kept = [s for s in self.served if s[1] is not None]
        n = min(int(self.ctx.traffic["check_requests"]), len(kept))
        pick = torch.randperm(len(kept), generator=data.cpu_generator(self.ctx.seed, "check"))[:n]
        self.checked = [(kept[j][0], kept[j][1].float().cpu(), kept[j][2]) for j in pick.tolist()]
        del self.served, self.table, self.model, self.qvars
        free(self.ctx.device)

    def check(self) -> dict:
        ctx = self.ctx
        ref = load_reference(ctx.config)
        ref.strict_f32()
        config, dev = ctx.config, ctx.device
        params = data.weights(config, self.spec.speakers, ctx.seed, dev)
        frag = ref.fragment_samples(config)
        rows = self.enrolled.flatten()
        raw = data.raw_windows(self.spec, ctx.seed, rows, torch.zeros_like(rows), frag, dev)
        support = ref.embed(params, ref.preprocess(raw, config), config)
        support = support.reshape(*self.enrolled.shape, -1)
        pool_i = torch.tensor([c[0] for c in self.checked])
        queries = ref.embed(params, ref.preprocess(self.pool[pool_i].to(dev), config), config)
        dist = ref.class_distances(queries, support).cpu()
        pred = torch.tensor([c[2] for c in self.checked])
        best = dist.min(dim=1).values
        gap = (dist[torch.arange(len(pred)), pred] - best) / best
        err = ref.relative_errors(torch.cat([c[1] for c in self.checked]), queries.cpu())
        return {"query_err_max": float(err.max()), "pred_gap_max": float(gap.max())}
