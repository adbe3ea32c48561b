"""B9: the weighted-L1 score matrix of the siamese verification head.

Port of ``voicemap_tpu/ops/pallas_distance.py :: pallas_weighted_l1`` (its
kernel ``_l1_kernel``), with a leading batch axis:

    out[t, i, j] = Σ_d |q[t, i, d] − s[t, j, d]| · w[d] + b

``q (T, nq, D)`` and ``s (T, ns, D)`` are cast to f32, ``w`` is ``(D,)`` (any
shape with D values, as the head's weight) and ``b`` a scalar; the output is
``(T, nq, ns)`` f32. The kernel lives in ``csrc/weighted_l1.cu``;
``weighted_l1_reference`` is its plain PyTorch version. Both sum in ``d``
order, ``|q − s|·w`` rounded at each step, then ``+ b`` last, so they agree
bit for bit; ``(q − s).abs() @ w`` would leave the order to BLAS.

The port's callers: ``pairwise_weighted_l1`` and ``SiameseNet.score_support``
(``T = 1``), the n-shot head scores ``(T, 1, P)`` and the verification pairs
``(P, 1, 1)`` (``ops/distance.head_scores``).

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. The
kernel has no backward: on the card it is called for scores, under
``torch.no_grad`` or ``torch.inference_mode``.
"""

from __future__ import annotations

import torch

MAX_D = 1024  # the w that the kernel's row-vector form stages in shared memory


def weighted_l1_work(T: int, nq: int, ns: int, D: int) -> dict:
    """What the function must do, for its bound: ``bytes`` (q, s, w and b
    read once, the f32 output written once) and ``ops``, two f32
    instructions a term (a subtract, then an FMA of ``|diff|·w`` into the
    sum; the abs is an operand modifier); ``terms`` = T·nq·ns·D."""
    terms = T * nq * ns * D
    return {"bytes": 4 * (T * nq * D + T * ns * D + D + 1 + T * nq * ns),
            "ops": 2 * terms, "terms": terms}


def _bias(b, device) -> torch.Tensor:
    return torch.as_tensor(b, dtype=torch.float32, device=device).reshape(())


def weighted_l1_reference(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                          b) -> torch.Tensor:
    """Plain PyTorch version → ``(T, nq, ns)`` f32: the kernel's loop over
    ``d``, one rounded product and one rounded sum a step, then ``+ b``."""
    qf, sf = q.float(), s.float()
    wf = w.reshape(-1).float()
    T, nq, D = qf.shape
    acc = torch.zeros((T, nq, sf.shape[1]), dtype=torch.float32, device=qf.device)
    for d in range(D):
        acc = acc + (qf[:, :, None, d] - sf[:, None, :, d]).abs() * wf[d]
    return acc + _bias(b, qf.device)


def _check(q, s, w) -> None:
    if q.dim() != 3 or s.dim() != 3:
        raise ValueError(f"weighted_l1: q and s must be (T, n, D), got {tuple(q.shape)} "
                         f"and {tuple(s.shape)}")
    T, nq, D = q.shape
    if s.shape[0] != T or s.shape[2] != D:
        raise ValueError(f"weighted_l1: s {tuple(s.shape)} does not match q {tuple(q.shape)}")
    if w.numel() != D:
        raise ValueError(f"weighted_l1: w has {w.numel()} values, want D={D}")
    if min(T, nq, s.shape[1], D) < 1:
        raise ValueError(f"weighted_l1: every extent must be >= 1, got q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)}")
    if D > MAX_D:
        raise ValueError(f"weighted_l1: D={D} exceeds the kernel's maximum D={MAX_D}")
    if nq > 1 and (T > 65535 or -(-nq // 64) > 65535):
        raise ValueError(f"weighted_l1: the tiled form takes T and nq/64 under 65536, "
                         f"got T={T}, nq={nq}")
    if not all(t.is_floating_point() for t in (q, s, w)):
        raise ValueError("weighted_l1: q, s and w must be floating-point tensors")


def weighted_l1(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """B9: ``Σ_d |q − s|·w + b`` of every (t, i, j) → ``(T, nq, ns)`` f32."""
    if q.device.type == "cpu":
        return weighted_l1_reference(q, s, w, b)
    if q.device.type != "cuda":
        raise ValueError(f"weighted_l1: no kernel for device {q.device}")
    _check(q, s, w)
    bt = _bias(b, q.device).reshape(1)
    if any(t.device != q.device for t in (s, w, bt)):
        raise ValueError(f"weighted_l1: every tensor must lie on {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, s, w, bt)):
        raise ValueError("weighted_l1: the B9 kernel has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    qc = q.float().contiguous()
    sc = s.float().contiguous()
    wc = w.reshape(-1).float().contiguous()
    bc = bt.contiguous()
    T, nq, D = qc.shape
    ns = sc.shape[1]
    out = torch.empty((T, nq, ns), dtype=torch.float32, device=q.device)
    from .._build import check, library

    with torch.cuda.device(q.device):
        err = library().vm_weighted_l1(qc.data_ptr(), sc.data_ptr(), wc.data_ptr(),
                                       bc.data_ptr(), out.data_ptr(), T, nq, ns, D,
                                       torch.cuda.current_stream().cuda_stream)
    check(err, "weighted_l1")
    weighted_l1.launches += 1
    return out


weighted_l1.launches = 0  # kernel launches; the CPU path does not count
