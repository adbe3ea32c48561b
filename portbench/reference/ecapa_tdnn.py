"""Plain reference of ECAPA-TDNN's embedding, in float32 with TF32 off, and
the seeded weights that the program and this reference are both handed.

The model as Desplanques, Thienpondt and Demuynck (Interspeech 2020,
arXiv:2005.07143) describe it and SpeechBrain's ``ECAPA_TDNN`` builds it for
``spkrec-ecapa-voxceleb``: a log-mel front end less its mean over time
(SpeechBrain's sentence-level ``InputNormalization``, no std); a TDNN layer;
SE-Res2Net blocks (1×1 TDNN, a Res2Net chain ``y_i = tdnn_i(x_i + y_{i−1})``
over an 8-way channel split, 1×1 TDNN, squeeze-excitation, the block's input
added); the three blocks' outputs concatenated into a 1×1 TDNN (MFA);
attentive statistics pooling with global context (``[h, mean_t h, std_t h]``
→ TDNN → tanh → 1×1 conv → softmax over time per channel → the weighted
mean and std); BatchNorm; a linear layer to the embedding. A TDNN is conv →
relu → BatchNorm. BatchNorm runs on its running statistics.

Departures from SpeechBrain's model, each shared with the program under test:

1. the convs pad SAME with zeros; SpeechBrain's ``Conv1d`` reflects at the
   edges (only the d·(k − 1)/2 edge frames of the k > 1 convs differ);
2. no relative-length mask: every window is whole;
3. the front end is the configuration's log-mel: frames of ``win_length``
   every ``hop_length`` samples from the first sample on (not centred), a
   periodic Hann window, the power spectrum at ``n_fft``, Slaney's mel scale
   and area-normalised triangles, the natural log of the power plus
   ``log_eps``; SpeechBrain centres its frames, builds its own triangular
   filters and takes 10·log10 with an 80 dB floor;
4. the weights are random, made from the seed (:func:`weights`), not the
   trained checkpoint's.

Written from the published description and the configuration's file alone:
it imports no module of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import data

CHUNK = 64  # rows at a time
CAL_ROWS = 16  # utterances of the pass that sets BatchNorm's running statistics
STAT_EPS = 1e-12  # SpeechBrain's floor under a variance before its square root


def strict_f32() -> None:
    """float32 products in float32: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fragment_samples(config: dict) -> int:
    d = config["data"]
    return int(d["seconds"] * d["sample_rate"])


def preprocess(raw: torch.Tensor, config: dict) -> torch.Tensor:
    """``(B, fragment)`` int16 → ``(B, fragment)`` f32, ÷ 32768 (no
    decimation, no whitening)."""
    return raw.float() / 32768.0


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------

def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    """Slaney's mel scale: linear (200/3 Hz a mel) below 1 kHz, logarithmic
    (ln 6.4 / 27 a mel) above."""
    lin = f / (200.0 / 3.0)
    log = 15.0 + torch.log(f.clamp(min=1e-300) / 1000.0) / (math.log(6.4) / 27.0)
    return torch.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    lin = m * (200.0 / 3.0)
    log = 1000.0 * torch.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return torch.where(m >= 15.0, log, lin)


def mel_filterbank(config: dict, device) -> torch.Tensor:
    """``(n_fft/2 + 1, n_mels)`` f32: triangles between ``n_mels + 2``
    points evenly spaced in mel from ``fmin`` to ``fmax``, each scaled by 2
    over its width in Hz (Slaney's area normalisation)."""
    mel, sr = config["mel"], config["data"]["sample_rate"]
    n_freq = mel["n_fft"] // 2 + 1
    fmax = mel.get("fmax") or sr / 2
    freqs = torch.linspace(0.0, sr / 2, n_freq, dtype=torch.float64, device=device)
    edge = lambda f: float(_hz_to_mel(torch.tensor(float(f), dtype=torch.float64)))  # noqa: E731
    pts = _mel_to_hz(torch.linspace(edge(mel["fmin"]), edge(fmax), mel["n_mels"] + 2,
                                    dtype=torch.float64, device=device))
    lo, ctr, hi = pts[:-2], pts[1:-1], pts[2:]
    up = (freqs[:, None] - lo) / (ctr - lo).clamp(min=1e-10)
    down = (hi - freqs[:, None]) / (hi - ctr).clamp(min=1e-10)
    return (torch.minimum(up, down).clamp(min=0.0) * (2.0 / (hi - lo))).float()


def log_mel(x: torch.Tensor, config: dict) -> torch.Tensor:
    """``(B, samples)`` → ``(B, frames, n_mels)`` in ``x``'s dtype."""
    mel = config["mel"]
    win, hop, n_fft = mel["win_length"], mel["hop_length"], mel["n_fft"]
    k = torch.arange(win, dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / win)).to(x.dtype)
    frames = x.unfold(-1, win, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return torch.log(power @ mel_filterbank(config, x.device).to(x.dtype) + mel["log_eps"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def tdnns(config: dict) -> list:
    """Every TDNN in forward order: ``(name, cin, cout, k, dilation)``."""
    enc = config["encoder"]
    C, ks, ds, scale = enc["channels"], enc["kernel_sizes"], enc["dilations"], enc["res2net_scale"]
    out = [("layer1", config["mel"]["n_mels"], C[0], ks[0], ds[0])]
    for i in range(1, len(C) - 1):
        w = C[i] // scale
        out.append((f"blocks.{i - 1}.tdnn1", C[i - 1], C[i], 1, 1))
        out += [(f"blocks.{i - 1}.res2net.{j}", w, w, ks[i], ds[i]) for j in range(scale - 1)]
        out.append((f"blocks.{i - 1}.tdnn2", C[i], C[i], 1, 1))
    out.append(("mfa", sum(C[1:-1]), C[-1], ks[-1], ds[-1]))
    out.append(("asp.tdnn", 3 * C[-1], enc["attention_channels"], 1, 1))
    return out


def _normalize(p: dict, name: str, a: torch.Tensor, eps: float) -> torch.Tensor:
    """BatchNorm on its running statistics over dim 1 of ``(B, C)`` or
    ``(B, C, T)``."""
    shape = (1, -1) + (1,) * (a.dim() - 2)
    v = lambda n: p[f"{name}.{n}"].reshape(shape)  # noqa: E731
    return (a - v("running_mean")) / torch.sqrt(v("running_var") + eps) * v("weight") + v("bias")


def _tdnn(p, name, h, k, dilation, norm):
    reach = dilation * (k - 1)
    a = torch.relu(F.conv1d(F.pad(h, (reach // 2, reach - reach // 2)),
                            p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], dilation=dilation))
    return norm(f"{name}.bn", a)


def _stats(h: torch.Tensor, w: torch.Tensor) -> tuple:
    """Mean and std over time (dim 2) of ``h`` under weights ``w`` that sum
    to 1 over time."""
    mean = (w * h).sum(dim=2)
    var = (w * (h - mean[:, :, None]).square()).sum(dim=2)
    return mean, var.clamp(min=STAT_EPS).sqrt()


def _forward(p: dict, x: torch.Tensor, config: dict, norm) -> torch.Tensor:
    """``(B, samples)`` → ``(B, D)``, BatchNorm by ``norm(name, a)``."""
    enc = config["encoder"]
    C, ks, ds, scale = enc["channels"], enc["kernel_sizes"], enc["dilations"], enc["res2net_scale"]
    m = log_mel(x, config)
    h = (m - m.mean(dim=1, keepdim=True)).transpose(1, 2)  # (B, n_mels, T)
    h = _tdnn(p, "layer1", h, ks[0], ds[0], norm)
    outs = []
    for i in range(1, len(C) - 1):
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
        h = y * s[:, :, None] + h
        outs.append(h)
    h = _tdnn(p, "mfa", torch.cat(outs, dim=1), ks[-1], ds[-1], norm)
    T = h.shape[2]
    mean, std = _stats(h, torch.full_like(h[:1, :1], 1.0 / T))
    ctx = torch.cat([h, mean[:, :, None].expand(-1, -1, T), std[:, :, None].expand(-1, -1, T)],
                    dim=1)
    a = torch.tanh(_tdnn(p, "asp.tdnn", ctx, 1, 1, norm))
    logits = F.conv1d(a, p["asp.conv.weight"][:, :, None], p["asp.conv.bias"])
    pooled = torch.cat(_stats(h, torch.softmax(logits, dim=2)), dim=1)
    return F.linear(norm("asp_bn", pooled), p["fc.weight"], p["fc.bias"])


def embed(params: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    """``(B, samples)`` f32 → ``(B, D)`` f32, ``CHUNK`` rows at a time."""
    eps = config["encoder"]["bn_epsilon"]
    p = {n: t.float() for n, t in params.items()}
    norm = lambda name, a: _normalize(p, name, a, eps)  # noqa: E731
    with torch.no_grad():
        return torch.cat([_forward(p, x[lo:lo + CHUNK].float(), config, norm)
                          for lo in range(0, x.shape[0], CHUNK)])


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def weights(config: dict, seed: int, device) -> dict:
    """The model's parameters and BatchNorm buffers in f32 on ``device``,
    by the names of the program's ``EcapaTDNN`` state: He-normal convs and
    linear layers (fan-in, ×2 before a relu), biases and BatchNorm shifts
    N(0, 0.1²), scales U(0.75, 1.25). Then one float64 pass of this
    reference over ``CAL_ROWS`` seeded utterances (tones in noise, as the
    store's rows) sets each BatchNorm's running mean and variance to those
    of the activations it sees there, times U(0.9, 1.1) and U(0.8, 1.25):
    no BatchNorm sits at its identity and nothing saturates. Float64 makes
    the pass the same whatever TF32 setting the caller runs under."""
    enc = config["encoder"]
    C, A, S, D = (enc["channels"][-1], enc["attention_channels"], enc["se_channels"],
                  enc["embedding_dim"])
    gen = torch.Generator(device=device).manual_seed(data.sub_seed(seed, "ecapa_weights"))
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device,  # noqa: E731
                                        dtype=torch.float64)
    uniform = lambda n, lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        n, generator=gen, device=device, dtype=torch.float64)
    p, factors = {}, {}

    def norm_params(name, c):
        p[f"{name}.weight"] = uniform(c, 0.75, 1.25)
        p[f"{name}.bias"] = 0.1 * normal(c)
        factors[name] = (uniform(c, 0.9, 1.1), uniform(c, 0.8, 1.25))

    for name, cin, cout, k, _ in tdnns(config):
        p[f"{name}.conv.weight"] = normal(cout, cin, k) * math.sqrt(2.0 / (cin * k))
        p[f"{name}.conv.bias"] = 0.1 * normal(cout)
        norm_params(f"{name}.bn", cout)
    for i in range(len(enc["channels"]) - 2):
        c = enc["channels"][i + 1]
        p[f"blocks.{i}.se.conv1.weight"] = normal(S, c) * math.sqrt(2.0 / c)
        p[f"blocks.{i}.se.conv1.bias"] = 0.1 * normal(S)
        p[f"blocks.{i}.se.conv2.weight"] = normal(c, S) * math.sqrt(1.0 / S)
        p[f"blocks.{i}.se.conv2.bias"] = 0.1 * normal(c)
    p["asp.conv.weight"] = normal(C, A) * math.sqrt(1.0 / A)
    p["asp.conv.bias"] = 0.1 * normal(C)
    norm_params("asp_bn", 2 * C)
    p["fc.weight"] = normal(D, 2 * C) * math.sqrt(1.0 / (2 * C))
    p["fc.bias"] = 0.1 * normal(D)

    eps = enc["bn_epsilon"]

    def calibrate(name, a):
        dims = [0] + list(range(2, a.dim()))
        mean_f, var_f = factors[name]
        p[f"{name}.running_mean"] = a.mean(dim=dims) * mean_f
        p[f"{name}.running_var"] = a.var(dim=dims, unbiased=False) * var_f
        return _normalize(p, name, a, eps)

    d = config["data"]
    spec = data.StoreSpec(CAL_ROWS, CAL_ROWS, d["seconds"], d["seconds"], d["sample_rate"])
    raw, _ = data.query_pool(spec, seed, CAL_ROWS, d["seconds"], device)
    with torch.no_grad():
        _forward(p, preprocess(raw, config).double(), config, calibrate)
    return {n: t.float() for n, t in p.items()}


def relative_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row ``‖got − want‖ / ‖want‖``."""
    return (got.double() - want.double()).norm(dim=1) / want.double().norm(dim=1).clamp(
        min=math.ulp(1.0))
