"""Plain reference of ECAPA-TDNN's training step, in float32 with TF32 off:
the forward of ``ecapa_tdnn.py`` with BatchNorm on the batch's statistics,
SpeechBrain's cosine classifier head and additive angular margin softmax,
autograd gradients, optax's clip by global norm, Adam with weight decay
(``torch.optim.Adam``'s L2 term, added after the clip) and BatchNorm's
running statistics.

As SpeechBrain's VoxCeleb recipe (``train_ecapa_tdnn.yaml``) trains
``spkrec-ecapa-voxceleb``: ``AdditiveAngularMargin(margin, scale)`` with
easy_margin False, then ``LogSoftmaxWrapper`` (a KL divergence to one-hot
targets, the mean cross-entropy); ``nn.BatchNorm1d``'s training mode
(biased variance to normalise, the unbiased one into the running variance,
momentum 0.1). The departures of ``ecapa_tdnn.py`` hold here too, and: no
augmentation, a learning rate held constant.

The forward follows the published form, ASP's TDNN on the 3C-channel
``[h, mean, std]`` input. Each stage (layer 1, a block, MFA, ASP with the
head) runs under ``torch.utils.checkpoint``, so that a 512-utterance step
at the published widths keeps only the stages' outputs and one stage's
activations at a time. Written from the published description and the
configuration's file alone: it imports no module of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import data
from .conv1d_encoder import clip_by_global_norm, leaf_gap, moving_leaves
from .ecapa_tdnn import _stats, _tdnn, fragment_samples, log_mel, preprocess, strict_f32, tdnns

__all__ = ["strict_f32", "preprocess", "fragment_samples", "leaf_gap", "moving_leaves",
           "draw_step", "head_weights", "aam_loss", "tdnn_names", "adam_update", "train",
           "variance_gap"]


def draw_step(gen: torch.Generator, n_utts: int, lengths: torch.Tensor, batch: int,
              window: int):
    """One step's draws in the order a step makes them from its generator:
    the utterance ids (uniform), then each window's start in samples
    (uniform over the row, ``u · (max_start + 1)`` in float32)."""
    dev = gen.device
    ids = torch.randint(0, n_utts, (batch,), generator=gen, device=dev)
    max_start = (lengths.to(dev)[ids] - window).clamp(min=0)
    u = torch.rand((batch,), generator=gen, device=dev)
    return ids, (u * (max_start + 1).float()).to(torch.int64)


def head_weights(config: dict, num_classes: int, seed: int, device) -> dict:
    """The cosine head's class weights ``(classes, D)`` f32, N(0, 1/D),
    named as the program's ``head.weight``."""
    D = config["encoder"]["embedding_dim"]
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(seed, "ecapa_head"))
    w = torch.randn((num_classes, D), generator=gen, device=device) * math.sqrt(1.0 / D)
    return {"head.weight": w}


def aam_loss(cosine: torch.Tensor, y: torch.Tensor, margin: float, scale: float):
    """SpeechBrain's ``AdditiveAngularMargin`` (easy_margin False) and
    ``LogSoftmaxWrapper``, written out."""
    cos = torch.clamp(cosine, -1 + 1e-7, 1 - 1e-7)
    sin = torch.sqrt(1.0 - torch.pow(cos, 2))
    phi = cos * math.cos(margin) - sin * math.sin(margin)
    phi = torch.where(cos > math.cos(math.pi - margin), phi,
                      cos - math.sin(math.pi - margin) * margin)
    onehot = F.one_hot(y.long(), cos.shape[1]).float()
    logits = scale * (onehot * phi + (1.0 - onehot) * cos)
    return -(F.log_softmax(logits, dim=1) * onehot).sum(dim=1).mean()


def tdnn_names(config: dict) -> list:
    """Every TDNN's BatchNorm in forward order."""
    return [f"{name}.bn" for name, *_ in tdnns(config)]


def _forward(p: dict, x: torch.Tensor, config: dict, norm) -> torch.Tensor:
    """``(B, samples)`` → ``(B, D)``, BatchNorm by ``norm(name, a)``, each
    stage checkpointed."""
    enc = config["encoder"]
    C, ks, ds, scale = enc["channels"], enc["kernel_sizes"], enc["dilations"], enc["res2net_scale"]
    with torch.no_grad():
        m = log_mel(x, config)
        h = (m - m.mean(dim=1, keepdim=True)).transpose(1, 2)  # (B, n_mels, T)

    def layer1(h):
        return _tdnn(p, "layer1", h, ks[0], ds[0], norm)

    def block(i, h):
        blk = f"blocks.{i - 1}"
        parts = _tdnn(p, f"{blk}.tdnn1", h, 1, 1, norm).chunk(scale, dim=1)
        ys = [parts[0]]
        for j in range(1, scale):
            ys.append(_tdnn(p, f"{blk}.res2net.{j - 1}", parts[j] if j == 1 else parts[j] + ys[-1],
                            ks[i], ds[i], norm))
        y = _tdnn(p, f"{blk}.tdnn2", torch.cat(ys, dim=1), 1, 1, norm)
        s = torch.relu(F.linear(y.mean(dim=2), p[f"{blk}.se.conv1.weight"],
                                p[f"{blk}.se.conv1.bias"]))
        s = torch.sigmoid(F.linear(s, p[f"{blk}.se.conv2.weight"], p[f"{blk}.se.conv2.bias"]))
        return y * s[:, :, None] + h

    def mfa(*outs):
        return _tdnn(p, "mfa", torch.cat(outs, dim=1), ks[-1], ds[-1], norm)

    def pool(h):
        T = h.shape[2]
        mean, std = _stats(h, torch.full_like(h[:1, :1], 1.0 / T))
        ctx = torch.cat([h, mean[:, :, None].expand(-1, -1, T),
                         std[:, :, None].expand(-1, -1, T)], dim=1)
        a = torch.tanh(_tdnn(p, "asp.tdnn", ctx, 1, 1, norm))
        logits = F.conv1d(a, p["asp.conv.weight"][:, :, None], p["asp.conv.bias"])
        pooled = torch.cat(_stats(h, torch.softmax(logits, dim=2)), dim=1)
        return F.linear(norm("asp_bn", pooled), p["fc.weight"], p["fc.bias"])

    run = lambda stage, *a: checkpoint(stage, *a, use_reentrant=False)  # noqa: E731
    h = run(layer1, h)
    outs = []
    for i in range(1, len(C) - 1):
        h = run(lambda h, i=i: block(i, h), h)
        outs.append(h)
    h = run(mfa, *outs)
    del outs
    return run(pool, h)


def loss_and_grads(theta: dict, x: torch.Tensor, y: torch.Tensor, config: dict,
                   recipe: dict):
    """The training forward and the gradient of the AAM loss with respect
    to every parameter → ``(loss, {name: grad}, {bn: (batch mean, unbiased
    batch variance)})``."""
    eps = config["encoder"]["bn_epsilon"]
    p = {n: t.detach().requires_grad_() for n, t in theta.items()}
    stats = {}

    def norm(name, a):
        dims = [0] + list(range(2, a.dim()))
        mean = a.mean(dim=dims)
        var = a.var(dim=dims, unbiased=False)
        if name not in stats:  # the checkpoints' recompute sees the same batch again
            n = a.numel() // a.shape[1]
            stats[name] = (mean.detach(), var.detach() * (n / (n - 1)))
        shape = (1, -1) + (1,) * (a.dim() - 2)
        return ((a - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
                * p[f"{name}.weight"].reshape(shape) + p[f"{name}.bias"].reshape(shape))

    emb = _forward(p, x, config, norm)
    cosine = F.linear(F.normalize(emb), F.normalize(p["head.weight"]))
    loss = aam_loss(cosine, y, recipe["aam_margin"], recipe["aam_scale"])
    names = list(p)
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    return loss.detach(), dict(zip(names, grads)), stats


@torch.no_grad()
def adam_update(theta: dict, grads: dict, m: dict, v: dict, t: int, recipe: dict) -> dict:
    """Adam's step ``t`` (from 1) on the clipped ``grads`` plus the L2 term
    ``wd·θ``: ``m`` and ``v`` updated in place → the new parameters."""
    b1, b2 = recipe["betas"]
    lr, eps, wd = recipe["learning_rate"], recipe["eps"], recipe["weight_decay"]
    out = {}
    for n, th in theta.items():
        g = grads[n] + wd * th
        m[n] = b1 * m[n] + (1 - b1) * g
        v[n] = b2 * v[n] + (1 - b2) * g.square()
        m_hat = m[n] / (1 - b1 ** t)
        v_hat = v[n] / (1 - b2 ** t)
        out[n] = th - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return out


def train(params: dict, batches, config: dict, recipe: dict, start: dict = None) -> dict:
    """Clipped Adam with weight decay from ``params`` (the encoder's
    parameters and BatchNorm buffers, and ``head.weight``) over ``batches``
    (``(x (B, samples), y (B,))`` each) → ``losses`` (each step's, before its
    update), ``grad1`` (the first step's clipped gradient), ``var1`` (the
    first step's unbiased batch variance of every BatchNorm), ``params``
    (after the last step) and ``running`` (BatchNorm's running statistics
    after it). ``start``: Adam's moments ``m``, ``v`` (by name) and the
    steps ``step`` taken before ``params``, to go on from a state (default:
    zero moments, step 0)."""
    momentum = recipe["bn_momentum"]
    buffers = ("running_mean", "running_var")
    names = [n for n in params if not n.endswith(buffers)]
    theta = {n: params[n].detach().clone().float() for n in names}
    running = {n: params[n].detach().clone().float() for n in params if n.endswith(buffers)}
    start = start or {"m": {}, "v": {}, "step": 0}
    m = {n: start["m"].get(n, torch.zeros_like(t)).float().clone() for n, t in theta.items()}
    v = {n: start["v"].get(n, torch.zeros_like(t)).float().clone() for n, t in theta.items()}
    losses, grad1, var1 = [], None, None
    for t, (x, y) in enumerate(batches, start=start["step"] + 1):
        loss, grads, stats = loss_and_grads(theta, x, y, config, recipe)
        grads = clip_by_global_norm(grads, recipe["clipnorm"])
        losses.append(float(loss))
        if grad1 is None:
            grad1 = grads
            var1 = {name: var for name, (_, var) in stats.items()}
        with torch.no_grad():
            for name, (mean, var) in stats.items():
                for buf, value in (("running_mean", mean), ("running_var", var)):
                    key = f"{name}.{buf}"
                    running[key] = (1.0 - momentum) * running[key] + momentum * value
            theta = adam_update(theta, grads, m, v, t, recipe)
    return {"losses": losses, "grad1": grad1, "var1": var1, "params": theta,
            "running": running}


def variance_gap(before: dict, after: dict, want: dict, momentum: float) -> float:
    """BatchNorm's unbiased batch variance of one step, recovered from the
    running variance before and after it (``after = (1 − m)·before +
    m·batch``), against the reference's: the median over a BatchNorm's
    channels of the relative gap, the largest over the BatchNorms named in
    ``want``."""
    gaps = []
    for name, w in want.items():
        got = (after[name].double() - (1.0 - momentum) * before[name].double()) / momentum
        w = w.double().cpu()
        gaps.append(float(((got.cpu() - w).abs() / w).median()))
    return max(gaps)
