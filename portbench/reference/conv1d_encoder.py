"""Plain reference of the 1D-conv speaker encoder and its classifier training
step, in float32 with TF32 off.

The model (oscarknagg/voicemap's ``get_baseline_convolutional_encoder`` as
the repository's configs state it): blocks × [Conv1D(SAME) → relu →
BatchNorm → SpatialDropout1D → MaxPool1D] → GlobalMaxPool1D → Dense, a
Dense classifier head, softmax cross-entropy, and optax's clip by global
norm followed by Adam. The fragment path of the data: int16 ÷ 32768, stride
decimation, whitening to a fixed RMS.

Written from the published description and the config files alone: it
imports no module of the program under test, and works out again whatever
the program derives (the decimated fragments, BatchNorm's folded affine,
the step's draws). Everything runs in row chunks, so that a 2048-row step at
full width fits the card: a training step is computed block by block, with
BatchNorm's batch statistics and its backward reductions summed over chunks
(float64 sums) and the full-rate activations computed again where needed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CHUNK = 128  # rows at a time


def strict_f32() -> None:
    """float32 products in float32: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def blocks(config: dict) -> list:
    """``[(cin, cout, k, pool, dilation)]`` from the config's encoder."""
    enc = config["encoder"]
    out, cin = [], 1
    for mult, k, pool, dil in zip(enc["filter_multipliers"], enc["kernel_sizes"],
                                  enc["pool_sizes"], enc["dilations"]):
        out.append((cin, enc["filters"] * mult, k, max(pool, 1), dil))
        cin = enc["filters"] * mult
    return out


def fragment_samples(config: dict) -> int:
    d = config["data"]
    return int(d["seconds"] * d["sample_rate"])


def preprocess(raw: torch.Tensor, config: dict) -> torch.Tensor:
    """``(B, fragment)`` int16 at the sample rate → ``(B, 1, T)`` f32: ÷
    32768, every ``downsampling``-th sample, zero mean and the fixed RMS."""
    d = config["data"]
    x = raw.float() / 32768.0
    x = x[:, ::d["downsampling"]]
    x = x - x.mean(dim=1, keepdim=True)
    rms = x.square().mean(dim=1, keepdim=True).sqrt()
    return (x * (d["whiten_rms"] / (rms + d["whiten_eps"])))[:, None, :]


def _conv(h, w, b, k, dilation):
    """SAME conv: XLA's padding, the odd one of an even reach on the right."""
    reach = dilation * (k - 1)
    return F.conv1d(F.pad(h, (reach // 2, reach - reach // 2)), w, b, dilation=dilation)


def _pool(y, pool):
    return F.max_pool1d(y, pool, pool) if pool > 1 else y


def embed(params: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    """Eval forward (BatchNorm on its running statistics) → ``(B, D)``."""
    eps = config["encoder"]["bn_epsilon"]
    out = []
    with torch.no_grad():
        for lo in range(0, x.shape[0], CHUNK):
            h = x[lo:lo + CHUNK].float()
            for i, (_, _, k, pool, dil) in enumerate(blocks(config)):
                p = lambda n: params[f"blocks.{i}.{n}"].float()  # noqa: E731
                a = torch.relu(_conv(h, p("w"), p("b"), k, dil))
                y = (a - p("mean")[:, None]) / torch.sqrt(p("var")[:, None] + eps)
                h = _pool(y * p("gamma")[:, None] + p("beta")[:, None], pool)
            out.append(F.linear(h.amax(dim=2), params["embed.w"], params["embed.b"]))
    return torch.cat(out)


def class_distances(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """``(Q, D)`` queries, ``(k, n, D)`` supports → ``(Q, k)``: the mean
    euclidean distance of each query to each class's supports."""
    diff = query[:, None, None, :] - support[None]
    return diff.square().sum(-1).sqrt().mean(-1)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def draw_step(gen: torch.Generator, n_utts: int, decimated_lengths: torch.Tensor, batch: int,
              model_length: int, channels: list, rate: float):
    """One step's draws in the order a classifier step makes them from its
    generator: the utterance ids (uniform), each fragment's start in
    decimated samples (uniform over the row), then one spatial-dropout keep
    mask a block, a Bernoulli(1 − rate) draw for each (row, channel)."""
    dev = gen.device
    ids = torch.randint(0, n_utts, (batch,), generator=gen, device=dev)
    max_start = (decimated_lengths.to(dev)[ids] - model_length).clamp(min=0)
    u = torch.rand((batch,), generator=gen, device=dev)
    starts = (u * (max_start + 1).float()).to(torch.int64)
    masks = [torch.empty((batch, c), device=dev).bernoulli_(1.0 - rate, generator=gen)
             for c in channels] if rate > 0 else [None] * len(channels)
    return ids, starts, masks


def _dropout(y, mask, rate):
    if mask is None:
        return y
    return torch.where(mask.bool()[:, :, None], y / (1.0 - rate), 0.0)


def _block_forward(h, p, k, dil):
    return torch.relu(_conv(h, p["w"], p["b"], k, dil))


def loss_and_grads(params: dict, x: torch.Tensor, y: torch.Tensor, masks: list,
                   config: dict):
    """The training forward (BatchNorm on the batch's statistics, the
    biased variance) and the gradient of the mean softmax cross-entropy with
    respect to every parameter → ``(loss, {name: grad}, [each block's batch
    variance])``."""
    enc = config["encoder"]
    eps, rate = enc["bn_epsilon"], enc["dropout"]
    shapes = blocks(config)
    B = x.shape[0]
    grads = {}
    ins, stats, variances = [x], [], []
    with torch.no_grad():
        for i, (_, cout, k, pool, dil) in enumerate(shapes):
            p = {n: params[f"blocks.{i}.{n}"] for n in ("w", "b", "gamma", "beta")}
            h = ins[-1]
            s1 = torch.zeros(cout, dtype=torch.float64, device=x.device)
            s2 = torch.zeros_like(s1)
            for lo in range(0, B, CHUNK):
                a = _block_forward(h[lo:lo + CHUNK], p, k, dil)
                s1 += a.sum((0, 2), dtype=torch.float64)
                s2 += a.square().sum((0, 2), dtype=torch.float64)
            n = B * h.shape[2]
            mu = s1 / n
            var = (s2 / n - mu * mu).clamp(min=0.0)
            variances.append(var)
            r = (1.0 / torch.sqrt(var + eps)).float()
            mu = mu.float()
            outs = []
            for lo in range(0, B, CHUNK):
                a = _block_forward(h[lo:lo + CHUNK], p, k, dil)
                yv = (a - mu[:, None]) * (r * p["gamma"])[:, None] + p["beta"][:, None]
                m = masks[i][lo:lo + CHUNK] if masks[i] is not None else None
                outs.append(_pool(_dropout(yv, m, rate), pool))
            ins.append(torch.cat(outs))
            stats.append((mu, r, n))
    # head: global max, Dense embedding, Dense logits, mean cross-entropy
    top = ins[-1].requires_grad_()
    head = {n: params[n].detach().requires_grad_() for n in ("embed.w", "embed.b", "head.w",
                                                             "head.b")}
    logits = F.linear(F.linear(top.amax(dim=2), head["embed.w"], head["embed.b"]),
                      head["head.w"], head["head.b"])
    loss = F.cross_entropy(logits, y.long())
    g = torch.autograd.grad(loss, [top, *head.values()])
    g_out = g[0]
    grads.update(dict(zip(head, g[1:])))
    for i in reversed(range(len(shapes))):
        _, cout, k, pool, dil = shapes[i]
        mu, r, n = stats[i]
        p = {nm: params[f"blocks.{i}.{nm}"] for nm in ("w", "b", "gamma", "beta")}
        h = ins[i]

        def routed(a, lo):
            """dL/dy of BatchNorm's output for rows from ``lo``, and x̂."""
            xhat = (a - mu[:, None]) * r[:, None]
            yv = (xhat * p["gamma"][:, None] + p["beta"][:, None]).requires_grad_()
            m = masks[i][lo:lo + a.shape[0]] if masks[i] is not None else None
            out = _pool(_dropout(yv, m, rate), pool)
            return torch.autograd.grad(out, yv, g_out[lo:lo + a.shape[0]])[0], xhat

        s_g = torch.zeros(cout, dtype=torch.float64, device=x.device)
        s_gx = torch.zeros_like(s_g)
        for lo in range(0, B, CHUNK):
            with torch.no_grad():
                a = _block_forward(h[lo:lo + CHUNK], p, k, dil)
            gy, xhat = routed(a, lo)
            s_g += gy.sum((0, 2), dtype=torch.float64)
            s_gx += (gy * xhat).sum((0, 2), dtype=torch.float64)
        grads[f"blocks.{i}.beta"] = s_g.float()
        grads[f"blocks.{i}.gamma"] = s_gx.float()
        mean_g, mean_gx = (s_g / n).float(), (s_gx / n).float()
        w = p["w"].detach().requires_grad_()
        b = p["b"].detach().requires_grad_()
        dw, db = torch.zeros_like(w), torch.zeros_like(b)
        g_in = torch.empty_like(h) if i > 0 else None
        for lo in range(0, B, CHUNK):
            hc = h[lo:lo + CHUNK].detach().requires_grad_(i > 0)
            a = torch.relu(_conv(hc, w, b, k, dil))
            gy, xhat = routed(a.detach(), lo)
            g_a = (p["gamma"] * r)[:, None] * (gy - mean_g[:, None] - xhat * mean_gx[:, None])
            wrt = [w, b] + ([hc] if i > 0 else [])
            got = torch.autograd.grad(a, wrt, g_a)
            dw += got[0]
            db += got[1]
            if i > 0:
                g_in[lo:lo + CHUNK] = got[2]
        grads[f"blocks.{i}.w"], grads[f"blocks.{i}.b"] = dw, db
        g_out = g_in
    return loss.detach(), grads, variances


def clip_by_global_norm(grads: dict, clipnorm: float) -> dict:
    """optax's form: when the global norm reaches ``clipnorm``, every
    gradient becomes ``(g / norm) · clipnorm``."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    if norm < clipnorm:
        return grads
    return {n: (g / norm) * clipnorm for n, g in grads.items()}


def train(params: dict, batches, config: dict, lr: float, clipnorm: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> dict:
    """Clipped Adam from ``params`` over ``batches`` (``(x, y, masks)`` each)
    → ``losses`` (each step's, before its update), ``grad1`` (the first
    step's clipped gradient), ``var1`` (the first step's batch variance of
    every block, float64) and ``params`` (after the last step)."""
    names = [n for n in params if not n.endswith((".mean", ".var"))]
    theta = {n: params[n].detach().clone().float() for n in names}
    m = {n: torch.zeros_like(t) for n, t in theta.items()}
    v = {n: torch.zeros_like(t) for n, t in theta.items()}
    losses, grad1, var1 = [], None, None
    for t, (x, y, masks) in enumerate(batches, start=1):
        loss, grads, variances = loss_and_grads(theta, x, y, masks, config)
        grads = clip_by_global_norm({n: grads[n] for n in names}, clipnorm)
        losses.append(float(loss))
        if grad1 is None:
            grad1, var1 = grads, variances
        with torch.no_grad():
            for n in names:
                m[n] = b1 * m[n] + (1 - b1) * grads[n]
                v[n] = b2 * v[n] + (1 - b2) * grads[n].square()
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                theta[n] = theta[n] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return {"losses": losses, "grad1": grad1, "var1": var1, "params": theta}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    each over the larger of the reference leaf's norm and the median leaf's
    norm; over the leaves ``keep`` (all when None)."""
    names = [n for n in reference if keep is None or n in keep]
    ref = {n: float(reference[n].double().norm()) for n in names}
    median = sorted(ref.values())[len(ref) // 2]
    return max(abs(float(program[n].double().norm()) - ref[n]) / max(ref[n], median, 1e-30)
               for n in names)


def variance_gap(before: list, after: list, want: list, momentum: float) -> float:
    """BatchNorm's batch variance of one step, recovered from the running
    variance before and after it (``after = m·before + (1 − m)·batch``),
    against the reference's: the median over a block's channels of the
    relative gap, the largest over the blocks."""
    gaps = []
    for b, a, w in zip(before, after, want):
        got = (a.double() - momentum * b.double()) / (1.0 - momentum)
        gaps.append(float(((got - w.double().cpu()).abs() / w.double().cpu()).median()))
    return max(gaps)


def moving_leaves(grad1: dict, share: float = 1e-3) -> set:
    """Leaves whose first gradient is not nought to rounding: norm at least
    ``share`` of the median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in grad1.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v >= share * median}


def model_length(config: dict) -> int:
    return fragment_samples(config) // config["data"]["downsampling"]


def relative_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row ``‖got − want‖ / ‖want‖``."""
    return (got.double() - want.double()).norm(dim=1) / want.double().norm(dim=1).clamp(
        min=math.ulp(1.0))
