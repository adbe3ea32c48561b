"""Bulk embedding: whole passes of ``eval.nshot.embed_rows`` over a store on
the card, back to back, one caller, closed loop.

Traffic parameters: ``store`` (a ``data.StoreSpec``), ``batch_size``,
``check_rows`` (rows of the last pass compared with the reference, drawn
from the seed), ``trace_seconds`` (the traced window).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.quant_infer import quantize_from_store

from .. import data, program
from ..reference import load as load_reference
from . import Context, closed_loop, free, synchronize


class Job:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = data.StoreSpec.of(ctx.traffic["store"])
        self.batch = int(ctx.traffic["batch_size"])
        self.done, self.passes = 0, 0

    def set_up(self) -> None:
        ctx = self.ctx
        self.cfg = program.experiment_config(ctx.config)
        self.store = program.device_store(self.spec, ctx.seed, self.cfg.data.downsampling,
                                          ctx.device)
        self.model = program.classifier(self.cfg, ctx.config, self.spec.speakers, ctx.seed,
                                        ctx.device)
        self.rows = torch.arange(self.spec.utterances, dtype=torch.int32, device=ctx.device)
        # the control: the program's own int8 serving path
        self.qvars = (quantize_from_store(self.model, self.cfg, self.store)
                      if ctx.variant == "int8" else None)
        self.unit()  # one pass: every batch shape the mix uses
        synchronize(ctx.device)
        self.done, self.passes = 0, 0

    def unit(self) -> None:
        with record_function("portbench.embed_rows"):
            self.table = nshot.embed_rows(self.model, self.store, self.cfg, self.rows,
                                          batch_size=self.batch, fast=True, qvars=self.qvars)
        self.done += self.spec.utterances
        self.passes += 1

    def window(self, seconds: float) -> float:
        return closed_loop(self.unit, seconds, self.ctx.device)

    def end_to_end(self, window_s: float) -> dict:
        return {"embed_utt_per_s": self.done / window_s}

    def batches(self) -> list:
        n = self.spec.utterances
        per_pass = [min(self.batch, n - lo) for lo in range(0, n, self.batch)]
        return per_pass * self.passes

    def work(self) -> dict:
        return {"attempted": self.done, "failed": 0, "utterances": self.done,
                "batches": self.batches()}

    def release(self) -> None:
        n = min(int(self.ctx.traffic["check_rows"]), self.spec.utterances)
        pick = torch.randperm(self.spec.utterances,
                              generator=data.cpu_generator(self.ctx.seed, "check"))[:n]
        self.sample = pick
        self.got = self.table[pick.to(self.table.device)].float().cpu()
        del self.table, self.store, self.model, self.qvars, self.rows
        free(self.ctx.device)

    def check(self) -> dict:
        ctx = self.ctx
        ref = load_reference(ctx.config)
        ref.strict_f32()
        params = data.weights(ctx.config, self.spec.speakers, ctx.seed, ctx.device)
        raw = data.raw_windows(self.spec, ctx.seed, self.sample, torch.zeros_like(self.sample),
                               ref.fragment_samples(ctx.config), ctx.device)
        want = ref.embed(params, ref.preprocess(raw, ctx.config), ctx.config).cpu()
        err = ref.relative_errors(self.got, want)
        return {"embed_err_max": float(err.max()), "embed_err_mean": float(err.mean())}
