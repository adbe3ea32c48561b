"""Classifier training: ``train.steps.make_classifier_train_step`` at the
traffic's batch, steps back to back with no host sync until the window ends.

Set-up builds one train state and drives it through ``checked_steps`` steps
of the same call the window makes, on one generator seeded from the seed
(ids, offsets and dropout masks all come from it); the window goes on with
that same state and generator. The reference follows those first steps.

Traffic parameters: ``store``, ``batch_size``, ``checked_steps``,
``trace_seconds`` (the traced window).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from voicemap_tpu_torch.train.state import init_state
from voicemap_tpu_torch.train.steps import make_classifier_train_step

from .. import data, program
from ..reference import load as load_reference
from . import Context, closed_loop, free, synchronize


class Job:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.spec = data.StoreSpec.of(ctx.traffic["store"])
        self.batch = int(ctx.traffic["batch_size"])
        self.checked = int(ctx.traffic["checked_steps"])
        self.steps = 0

    def set_up(self) -> None:
        ctx = self.ctx
        # the control: the program's own int8 training forward
        extra = {"quant_forward": "int8"} if ctx.variant == "int8" else {}
        self.cfg = program.experiment_config(ctx.config, batch_size=self.batch, **extra)
        self.store = program.device_store(self.spec, ctx.seed, self.cfg.data.downsampling,
                                          ctx.device)
        model = program.classifier(self.cfg, ctx.config, self.spec.speakers, ctx.seed,
                                   ctx.device)
        t = self.cfg.train
        self.state = init_state(model, t.clipnorm, t.learning_rate)
        self.step, _ = make_classifier_train_step(model, self.cfg)
        self.gen = torch.Generator(device=ctx.device).manual_seed(data.sub_seed(ctx.seed, "steps"))
        leaves = program.leaves(model)
        self.theta0 = {n: p.detach().clone() for n, p in leaves.items()}
        self.losses, self.grad1, self.var1 = [], None, None
        bn = [blk.bn for blk in model.encoder.blocks]
        beta1 = self.state.optimizer.adam.defaults["betas"][0]
        for _ in range(self.checked):  # the first steps: checked, and every shape warmed
            self.state, metrics = self.step(self.state, self.store, self.gen)
            self.losses.append(metrics["loss"])
            if self.grad1 is None:  # the clipped gradient, from Adam's first moment
                adam = self.state.optimizer.adam.state
                self.grad1 = {n: adam[p]["exp_avg"] / (1.0 - beta1) if p in adam
                              else torch.zeros_like(p) for n, p in leaves.items()}
                self.var1 = [b.running_var.detach().clone() for b in bn]
        self.theta_k = {n: p.detach().clone() for n, p in leaves.items()}
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
        self.var1 = [v.cpu() for v in self.var1]
        del self.state, self.step, self.store, self.gen
        free(self.ctx.device)

    def check(self) -> dict:
        ctx = self.ctx
        ref = load_reference(ctx.config)
        ref.strict_f32()
        config, dev = ctx.config, ctx.device
        params = data.weights(config, self.spec.speakers, ctx.seed, dev)
        ds = config["data"]["downsampling"]
        dec_lengths = data.lengths(self.spec, ctx.seed) // ds
        labels = data.labels(self.spec).to(dev)
        channels = [cout for _, cout, _, _, _ in ref.blocks(config)]
        gen = torch.Generator(device=dev).manual_seed(data.sub_seed(ctx.seed, "steps"))
        batches = []
        for _ in range(self.checked):
            ids, starts, masks = ref.draw_step(gen, self.spec.utterances, dec_lengths,
                                               self.batch, ref.model_length(config), channels,
                                               config["encoder"]["dropout"])
            raw = data.raw_windows(self.spec, ctx.seed, ids, starts * ds,
                                   ref.fragment_samples(config), dev)
            batches.append((ref.preprocess(raw, config), labels[ids], masks))
            del raw
        t = config["train"]
        out = ref.train(params, batches, config, t["learning_rate"], t["clipnorm"])
        host = lambda d: {n: v.float().cpu() for n, v in d.items()}  # noqa: E731
        grad1, theta_k = host(out["grad1"]), host(out["params"])
        change_p = {n: self.theta_k[n] - self.theta0[n] for n in theta_k}
        change_r = {n: theta_k[n] - params[n].float().cpu() for n in theta_k}
        moving = ref.moving_leaves(grad1)
        gaps = {f"loss{i}_gap": abs(p - r) / abs(r)
                for i, (p, r) in enumerate(zip(self.losses, out["losses"]), start=1)}
        var0 = [params[f"blocks.{i}.var"].cpu() for i in range(len(channels))]
        return {**gaps, "grad_gap": ref.leaf_gap(self.grad1, grad1),
                "change_gap": ref.leaf_gap(change_p, change_r, keep=moving),
                "bn_var_gap": ref.variance_gap(var0, self.var1, out["var1"],
                                               config["encoder"]["bn_momentum"])}
