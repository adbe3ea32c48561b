"""Attribute the gap between config #1's bf16 train step through the kernels
and through their plain versions to each kernel, and to each of B4's and
B5's outputs.

    python3 step_attrib.py [--seeds 0 1 2] [--quant-forward int8] [--dtype float32]

For each seed, one classifier step as ``chip_smoke.py``'s
``compare_plain_step`` takes it (config #1 at full width, batch 32, random
weights and a synthetic store from the seed) runs with every train kernel
replaced by its plain version: the reference. Then it runs once for each
variant in ``VARIANTS``, with some kernels, or some outputs of a kernel, put
back, and prints one JSON line a variant: the loss's relative difference
from the reference, every parameter's gradient cosine against it, the worst
one (``min_at``), and what the kernels changed at the step's own inputs
(B4's ``a_sel`` elements that differ from the plain version's and by how
many bf16 ulps, #(a > 0)'s flips, Σa's and B5's dW's and db's largest
difference over the largest value; and the channels of block 0's conv bias
whose gradient moved most, each with E[a²]/var from the plain statistics).
``plain`` runs the reference again, so it shows what the rest of the step
(cuDNN, the optimizer) varies from run to run. ``a_sel_flips`` runs every plain version with ``a_sel`` moved by one
bf16 ulp at as many random nonzero elements as B4's kernel changes: a
rounding change of the kernel's size with no kernel at all.

``--quant-forward int8`` takes the same step through the int8 train forward
(``fused_int8``; variant ``b3_train`` puts back B3's train epilogue alone),
``--dtype float32`` in f32 compute.

It reaches the train path through the ``chip_smoke`` beside it and the
wrappers' public signatures: run from the root of a checkout, it measures
that checkout, and ``python3 build/parent/step_attrib.py`` measures a parent
unpacked there (``git archive``), whose own directory comes first on
``sys.path``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs

B4, B5 = "conv_block0_train", "conv_block0_train_bwd"
ALL = {B4: "kernel", B5: "kernel", "pool_fwd": "kernel", "route_bwd": "kernel",
       "quant_block_train": "kernel", "conv_blockn_rows": "kernel", "bn_apply": "kernel",
       "bn_grad": "kernel"}
# Variant → {wrapper: what it returns}; wrappers not named are plain.
# B4: "kernel", "a_sel" (the kernel's a_sel, the plain statistics), "stats"
# (the plain a_sel, the kernel's statistics), "flips" (see the docstring);
# B5: "kernel", "dw", "db" (that output from the kernel, the other plain).
VARIANTS = {
    "plain": {},
    "all": ALL,
    "b4": {B4: "kernel"},
    "b4_a_sel": {B4: "a_sel"},
    "b4_stats": {B4: "stats"},
    "a_sel_flips": {B4: "flips"},
    "b5": {B5: "kernel"},
    "b5_dw": {B5: "dw"},
    "b5_db": {B5: "db"},
    "b7": {"pool_fwd": "kernel", "route_bwd": "kernel"},
    "bn_epilogue": {"bn_apply": "kernel", "bn_grad": "kernel"},
    "b3_train": {"quant_block_train": "kernel"},
}
BIAS0 = "encoder.blocks.0.conv.bias"
_INT_OF = {torch.bfloat16: torch.int16, torch.float32: torch.int32}  # a_sel's bits
STORE = dict(n_speakers=40, utterances_per_speaker=8, min_seconds=3.5, max_seconds=6.0)


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) / scale if scale else 0.0


def flip_ulps(a: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """``a`` (bf16 or f32) with ``n`` of its nonzero elements, drawn from
    ``seed``, moved by one ulp up or down."""
    itype = _INT_OF[a.dtype]
    bits = a.contiguous().view(itype).flatten().clone()
    nonzero = (bits != 0).nonzero().flatten()
    gen = torch.Generator(device=a.device).manual_seed(seed)
    pick = nonzero[torch.randperm(nonzero.numel(), generator=gen, device=a.device)[:n]]
    step = torch.randint(0, 2, (pick.numel(),), generator=gen, device=a.device) * 2 - 1
    bits[pick] += step.to(itype)
    return bits.view(a.dtype).view(a.shape)


def b4_variant(kernel, plain, take: str, probe: dict, seed: int):
    def fn(*args, **kw):
        ref = plain(*args, **kw)
        out = kernel(*args, **kw)
        differ = out[0] != ref[0]
        itype = _INT_OF[out[0].dtype]
        ulps = (out[0].view(itype).long() - ref[0].view(itype).long()).abs()
        n = args[0].shape[0] * args[0].shape[1]
        mean_sq = ref[2].double() / n
        var = mean_sq - (ref[1].double() / n) ** 2
        probe.update(a_sel_differ=int(differ.sum()), a_sel_elements=differ.numel(),
                     a_sel_max_ulps=int(ulps.max()),
                     relu_flips=float((out[3] - ref[3]).abs().sum()),
                     sum_a_rel=rel_diff(out[1], ref[1]), sum_a2_rel=rel_diff(out[2], ref[2]),
                     # None for a channel that relu leaves at 0 everywhere.
                     mean_sq_over_var=[float(m / v) if m > 0 else None
                                       for m, v in zip(mean_sq.tolist(), var.tolist())])
        if take == "kernel":
            return out
        if take == "a_sel":
            return (out[0], *ref[1:])
        if take == "stats":
            return (ref[0], *out[1:])
        return (flip_ulps(ref[0], probe["a_sel_differ"], seed), *ref[1:])
    return fn


def b5_variant(kernel, plain, take: str, probe: dict):
    def fn(*args, **kw):
        ref = plain(*args, **kw)
        out = kernel(*args, **kw)
        probe.update(dw_rel=rel_diff(out[0], ref[0]), db_rel=rel_diff(out[1], ref[1]))
        return {"kernel": out, "dw": (out[0], ref[1]), "db": (ref[0], out[1])}[take]
    return fn


def wrappers(spec: dict, probe: dict, seed: int) -> dict:
    """Each train wrapper's stand-in under ``spec``, by name. A stand-in
    that calls the wrapper takes its counters: the wrapper counts a launch
    on whatever its module's name holds."""
    use = {}
    for mod, name, plain in cs.PLAIN:
        kernel, take = getattr(mod, name), spec.get(name)
        if take is None:
            use[name] = plain
        elif name in (B4, B5):
            fn = (b4_variant(kernel, plain, take, probe, seed) if name == B4
                  else b5_variant(kernel, plain, take, probe))
            fn.__dict__.update(vars(kernel))
            use[name] = fn
        else:
            use[name] = kernel
    return use


def train_step(seed: int, quant_forward: str = "none", dtype: str = None):
    """chip_smoke's ``compare_plain_step`` set-up: the model, its weights'
    snapshot, its config and the step, from ``seed`` (with
    ``quant_forward``, in compute ``dtype`` where given)."""
    host = cs.synthetic_store(seed, **STORE)
    base = cs.classifier_baseline()
    cfg = base.replace(train=dataclasses.replace(
        base.train, batch_size=cs.TRAIN_BATCH, num_steps=cs.TRAIN_STEPS,
        evaluate_every=cs.TRAIN_STEPS, num_eval_tasks=500, seed=seed,
        quant_forward=quant_forward))
    if dtype is not None:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, compute_dtype=dtype))
    store = cs.device_store_for(cfg, host, cs.DEVICE)
    n = len(host.label_names)
    model = cs.SpeakerClassifier(cfg.encoder, n, device=cs.DEVICE)
    model.load_state_dict(cs.from_flax(cs.random_flax_variables(cfg.encoder, n, seed),
                                       cfg.encoder))
    gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
    idx = cs.sampling.sample_classifier_batch(gen, store.labels.shape[0], cs.TRAIN_BATCH,
                                              cs.DEVICE)
    x, y = cs.fetch_batch(store, idx, cfg, gen), store.labels[idx]
    loss_fn = cs.steps.classifier_loss_fn(model, cfg)

    def run(state):
        drop = torch.Generator(device=cs.DEVICE).manual_seed(seed + 1)
        return cs.steps.train_on_batch(state, x, y, drop, loss_fn)[1]

    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    return model, snapshot, cfg, run


def grads_under(use: dict, model, snapshot: dict, cfg, run) -> tuple[float, dict]:
    model.load_state_dict(snapshot)
    state = cs.init_state(model, cfg.train.clipnorm, cfg.train.learning_rate)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in cs.PLAIN]
    for mod, name, _ in cs.PLAIN:
        setattr(mod, name, use[name])
    try:
        loss = float(run(state)["loss"])
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return loss, {k: p.grad.detach().double().flatten().clone()
                  for k, p in model.named_parameters() if p.grad is not None}


def attribute(seed: int, variants: dict = VARIANTS, quant_forward: str = "none",
              dtype: str = None):
    """Yield one record a variant at ``seed``."""
    model, snapshot, cfg, run = train_step(seed, quant_forward, dtype)
    loss_p, grads_p = grads_under(wrappers({}, {}, seed), model, snapshot, cfg, run)
    for variant, spec in variants.items():
        probe = {}
        loss, grads = grads_under(wrappers(spec, probe, seed), model, snapshot, cfg, run)
        cos = {k: float(torch.nn.functional.cosine_similarity(grads[k], grads_p[k], dim=0))
               for k in grads_p if float(grads_p[k].norm()) > 0}
        worst = min(cos, key=cos.get)
        ratio = probe.pop("mean_sq_over_var", None)
        if ratio is not None:
            # Block 0's conv bias gradient: the channels that carry most of
            # its difference, each with E[a²]/var, the factor by which the
            # f32 variance E[a²] − μ² magnifies a relative change in a sum.
            err = (grads[BIAS0] - grads_p[BIAS0]).abs()
            total = float((err ** 2).sum()) or 1.0
            top = err.argsort(descending=True, stable=True)[:5].tolist()
            probe["bias0_top_channels"] = [
                {"channel": c, "err_share": float(err[c] ** 2) / total,
                 "grad": float(grads_p[BIAS0][c]), "mean_sq_over_var": ratio[c]} for c in top]
            probe["mean_sq_over_var_median"] = float(
                torch.tensor([r for r in ratio if r is not None]).median())
        yield {"seed": seed, "variant": variant, "quant_forward": quant_forward,
               "dtype": cfg.encoder.compute_dtype, "loss_plain": loss_p, "loss": loss,
               "loss_rel_diff": abs(loss - loss_p) / abs(loss_p),
               "min_grad_cosine": cos[worst], "min_at": worst, "cosines": cos, "probe": probe}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--quant-forward", default="none", choices=["none", "int8"])
    parser.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                        help="compute dtype (default: the config's, bf16)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_attrib: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    package = os.path.dirname(os.path.abspath(cs.__file__))
    for seed in args.seeds:
        for record in attribute(seed, quant_forward=args.quant_forward, dtype=args.dtype):
            print(json.dumps({"checkout": package, **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
