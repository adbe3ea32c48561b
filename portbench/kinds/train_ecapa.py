"""ECAPA-TDNN training: ``train.steps.make_ecapa_train_step`` at the traffic's
batch, steps back to back with no host sync until the window ends.

The configuration's file is ``configs/ecapa_tdnn_train.json``: the embed
cell's model as SpeechBrain's VoxCeleb recipe trains it, with the same
widths. The training recipe is the traffic's ``recipe``: the additive angular margin
softmax's margin and scale over the cosine head, Adam's learning rate
(held), betas, eps and weight decay, the clip's global norm, and
BatchNorm's momentum (the program's ``nn.BatchNorm1d`` default, which the
reference is told). The encoder's weights are the reference's
(``reference/ecapa_tdnn.weights``), the head's ``head_weights``, from the
seed.

Set-up builds one train state and drives it through ``checked_steps``
steps of the same call the window makes, on one generator seeded from the
seed (ids and offsets come from it), then ``profiled_steps`` more under the
profiler the traced window uses, discarded; the window goes on with that
state and generator. The step's host time is close to its device time, and
the profiler's first seconds in a process cost the host more a step than
its later ones: set-up spends them, so that a traced window reads the
profiler's steady cost, not its start. The reference
(``reference/ecapa_tdnn_train``) follows the checked steps, and the check
compares: the losses of steps 2 and 3, the first clipped gradient and the
parameters' change over the steps (the worst leaf's gap of norms, as the
classifier's train cell), and each TDNN's batch variance of step 1
recovered from its running variance (the worst TDNN's median gap).

``--variant int8`` runs ``controls_ecapa_train``'s ``fp8`` control (each
TDNN's output rounded to float8 e4m3 in the training forward).

Traffic parameters: ``store``, ``batch_size``, ``checked_steps``,
``profiled_steps``, ``trace_seconds`` (the traced window), ``recipe``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from voicemap_tpu_torch.train.state import init_state
from voicemap_tpu_torch.train.steps import make_ecapa_train_step

from .. import controls_ecapa_train, data, program, trace
from ..reference import ecapa_tdnn as ref_model
from ..reference import ecapa_tdnn_train as ref
from . import Context, closed_loop, free, synchronize
from .embed_ecapa import experiment_config, model as ecapa_model


def train_config(config: dict, traffic: dict):
    """The ECAPA preset with the file's values, the traffic's batch and its
    recipe."""
    r = traffic["recipe"]
    cfg = experiment_config(config)
    t = dataclasses.replace(cfg.train, batch_size=int(traffic["batch_size"]),
                            learning_rate=float(r["learning_rate"]),
                            clipnorm=float(r["clipnorm"]))
    return cfg.replace(train=t, aam_margin=float(r["aam_margin"]),
                       aam_scale=float(r["aam_scale"]), weight_decay=float(r["weight_decay"]))


def leaves(model) -> dict:
    """The model's parameters by the reference's names."""
    out = {n: p for n, p in model.encoder.named_parameters()}
    out["head.weight"] = model.head.weight
    return out


def variances(model, names: list) -> dict:
    bn = dict(model.encoder.named_modules())
    return {f"{n}.running_var": bn[n].running_var.detach().float().clone() for n in names}


class Job:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = data.StoreSpec.of(ctx.traffic["store"])
        self.batch = int(ctx.traffic["batch_size"])
        self.checked = int(ctx.traffic["checked_steps"])
        self.profiled = int(ctx.traffic["profiled_steps"])
        self.recipe = ctx.traffic["recipe"]
        self.steps = 0

    def set_up(self) -> None:
        ctx = self.ctx
        if ctx.variant == "int8":
            controls_ecapa_train.plant("fp8")
        self.cfg = train_config(ctx.config, ctx.traffic)
        self.store = program.device_store(self.spec, ctx.seed, self.cfg.data.downsampling,
                                          ctx.device)
        model = ecapa_model(self.cfg, ctx.config, self.spec.speakers, ctx.seed, ctx.device)
        head = ref.head_weights(ctx.config, self.spec.speakers, ctx.seed, ctx.device)
        with torch.no_grad():
            model.head.weight.copy_(head["head.weight"])
        t = self.cfg.train
        self.state = init_state(model, t.clipnorm, t.learning_rate, self.cfg.weight_decay)
        self.step, _ = make_ecapa_train_step(model, self.cfg)
        self.gen = torch.Generator(device=ctx.device).manual_seed(data.sub_seed(ctx.seed, "steps"))
        params = leaves(model)
        self.bn_names = ref.tdnn_names(ctx.config)
        self.theta0 = {n: p.detach().clone() for n, p in params.items()}
        self.var0 = variances(model, self.bn_names)
        self.losses, self.grad1, self.var1 = [], None, None
        for _ in range(self.checked):  # the first steps: checked, and every shape warmed
            self.state, metrics = self.step(self.state, self.store, self.gen)
            self.losses.append(metrics["loss"])
            if self.grad1 is None:  # the clipped gradient (Adam adds its L2 term apart)
                self.grad1 = {n: p.grad.detach().clone() if p.grad is not None
                              else torch.zeros_like(p) for n, p in params.items()}
                self.var1 = variances(model, self.bn_names)
        self.theta_k = {n: p.detach().clone() for n, p in params.items()}
        with trace.traced(ctx.device):
            for _ in range(self.profiled):
                self.state, _ = self.step(self.state, self.store, self.gen)
            synchronize(ctx.device)

    def unit(self) -> None:
        with record_function("portbench.train_step"):
            self.state, _ = self.step(self.state, self.store, self.gen)
        self.steps += 1

    def window(self, seconds: float) -> float:
        return closed_loop(self.unit, seconds, self.ctx.device)

    def end_to_end(self, window_s: float) -> dict:
        return {"train_utt_per_s": self.steps * self.batch / window_s}

    def work(self) -> dict:
        return {"attempted": self.steps, "failed": 0, "steps": self.steps,
                "batch_size": self.batch, "utterances": self.steps * self.batch}

    def release(self) -> None:
        host = lambda d: {n: t.float().cpu() for n, t in d.items()}  # noqa: E731
        self.losses = [float(v) for v in self.losses]
        self.theta0, self.theta_k, self.grad1 = (host(self.theta0), host(self.theta_k),
                                                 host(self.grad1))
        self.var0, self.var1 = host(self.var0), host(self.var1)
        del self.state, self.step, self.store, self.gen
        free(self.ctx.device)

    def check(self) -> dict:
        ctx = self.ctx
        ref.strict_f32()
        config, dev = ctx.config, ctx.device
        params = {**ref_model.weights(config, ctx.seed, dev),
                  **ref.head_weights(config, self.spec.speakers, ctx.seed, dev)}
        lengths = data.lengths(self.spec, ctx.seed)
        labels = data.labels(self.spec).to(dev)
        window = ref.fragment_samples(config)
        gen = torch.Generator(device=dev).manual_seed(data.sub_seed(ctx.seed, "steps"))
        batches = []
        for _ in range(self.checked):
            ids, starts = ref.draw_step(gen, self.spec.utterances, lengths, self.batch, window)
            raw = data.raw_windows(self.spec, ctx.seed, ids, starts, window, dev)
            batches.append((ref.preprocess(raw, config), labels[ids]))
            del raw
        out = ref.train(params, batches, config, self.recipe)
        host = lambda d: {n: v.float().cpu() for n, v in d.items()}  # noqa: E731
        grad1, theta_k = host(out["grad1"]), host(out["params"])
        change_p = {n: self.theta_k[n] - self.theta0[n] for n in theta_k}
        change_r = {n: theta_k[n] - params[n].float().cpu() for n in theta_k}
        gaps = {f"loss{i}_gap": abs(p - r) / abs(r)
                for i, (p, r) in enumerate(zip(self.losses, out["losses"]), start=1)}
        want = {f"{n}.running_var": out["var1"][n] for n in self.bn_names}
        return {**gaps, "grad_gap": ref.leaf_gap(self.grad1, grad1),
                "change_gap": ref.leaf_gap(change_p, change_r,
                                           keep=ref.moving_leaves(grad1)),
                "bn_var_gap": ref.variance_gap(self.var0, self.var1, want,
                                               float(self.recipe["bn_momentum"]))}
