"""Bulk embedding through ECAPA-TDNN: whole passes of ``eval.nshot.embed_rows``
over an undecimated 16 kHz store on the card, back to back, one caller,
closed loop (``embed.py``'s loop, on a model of ``models/ecapa``).

The configuration's file names the port's ``ecapa_tdnn`` preset and gives
its ``encoder`` (``EcapaConfig``), ``data`` and ``mel`` values; the weights
are the reference's (``reference/ecapa_tdnn.weights``), made from the seed.

Traffic parameters: ``store`` (a ``data.StoreSpec``), ``batch_size``,
``check_rows`` (rows of the last pass compared with the reference, drawn
from the seed), ``trace_seconds`` (the traced window).

``--variant int8``, the control a cell's run can ask for, has no int8 path
to take here: it runs the lower-precision control of ``controls_ecapa``
(activations rounded to float8 e4m3 after every TDNN).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from voicemap_tpu_torch import config as vm_config
from voicemap_tpu_torch.eval import nshot
from voicemap_tpu_torch.models.ecapa import EcapaClassifier

from .. import controls_ecapa, data, program
from ..reference import load as load_reference
from . import Context, closed_loop, free, synchronize


def experiment_config(config: dict) -> vm_config.EcapaExperimentConfig:
    """The preset the file names, with the file's encoder, data and mel
    values."""
    cfg = vm_config.PORT_PRESETS[config["preset"]]()
    return cfg.replace(ecapa=program._group(cfg.ecapa, config["encoder"]),
                       data=program._group(cfg.data, config["data"]),
                       mel=program._group(cfg.mel, config["mel"]))


def model(cfg, config: dict, num_classes: int, seed: int, device) -> EcapaClassifier:
    """The port's ECAPA-TDNN holding the reference's weights for ``seed``."""
    m = EcapaClassifier(cfg.ecapa, cfg.mel, num_classes, cfg.data.sample_rate, device=device)
    state = m.encoder.state_dict()
    made = load_reference(config).weights(config, seed, device)
    floating = {k for k, t in state.items() if t.is_floating_point()}
    if floating != set(made):
        raise ValueError(f"made weights do not match the model: {sorted(floating ^ set(made))}")
    state.update(made)
    m.encoder.load_state_dict(state, strict=True)
    return m


class Job:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = data.StoreSpec.of(ctx.traffic["store"])
        self.batch = int(ctx.traffic["batch_size"])
        self.done, self.passes = 0, 0

    def set_up(self) -> None:
        ctx = self.ctx
        if ctx.variant == "int8":
            controls_ecapa.plant("fp8")
        self.cfg = experiment_config(ctx.config)
        self.store = program.device_store(self.spec, ctx.seed, self.cfg.data.downsampling,
                                          ctx.device)
        self.model = model(self.cfg, ctx.config, self.spec.speakers, ctx.seed, ctx.device)
        self.rows = torch.arange(self.spec.utterances, dtype=torch.int32, device=ctx.device)
        self.unit()  # one pass: every batch shape the mix uses
        synchronize(ctx.device)
        self.done, self.passes = 0, 0

    def unit(self) -> None:
        with record_function("portbench.embed_rows"):
            self.table = nshot.embed_rows(self.model, self.store, self.cfg, self.rows,
                                          batch_size=self.batch, fast=True)
        self.done += self.spec.utterances
        self.passes += 1

    def window(self, seconds: float) -> float:
        return closed_loop(self.unit, seconds, self.ctx.device)

    def end_to_end(self, window_s: float) -> dict:
        return {"embed_utt_per_s": self.done / window_s}

    def batches(self) -> list:
        n = self.spec.utterances
        return [min(self.batch, n - lo) for lo in range(0, n, self.batch)] * self.passes

    def work(self) -> dict:
        return {"attempted": self.done, "failed": 0, "utterances": self.done,
                "batches": self.batches()}

    def release(self) -> None:
        n = min(int(self.ctx.traffic["check_rows"]), self.spec.utterances)
        pick = torch.randperm(self.spec.utterances,
                              generator=data.cpu_generator(self.ctx.seed, "check"))[:n]
        self.sample = pick
        self.got = self.table[pick.to(self.table.device)].float().cpu()
        del self.table, self.store, self.model, self.rows
        free(self.ctx.device)

    def check(self) -> dict:
        ctx = self.ctx
        ref = load_reference(ctx.config)
        ref.strict_f32()
        params = ref.weights(ctx.config, ctx.seed, ctx.device)
        raw = data.raw_windows(self.spec, ctx.seed, self.sample, torch.zeros_like(self.sample),
                               ref.fragment_samples(ctx.config), ctx.device)
        want = ref.embed(params, ref.preprocess(raw, ctx.config), ctx.config).cpu()
        err = ref.relative_errors(self.got, want)
        return {"embed_err_max": float(err.max()), "embed_err_mean": float(err.mean())}
