"""B9: the weighted-L1 score matrix of the siamese verification head.

Port of ``voicemap_tpu/ops/pallas_distance.py :: pallas_weighted_l1`` (its
kernel ``_l1_kernel``), with a leading batch axis:

    out[t, i, j] = Σ_d |q[t, i, d] − s[t, j, d]| · w[d] + b

``q (T, nq, D)`` and ``s (T, ns, D)`` are cast to f32, ``w`` is ``(D,)`` (any
shape with D values, as the head's weight) and ``b`` a scalar; the output is
``(T, nq, ns)`` f32. The kernel lives in ``csrc/weighted_l1.cu``;
``weighted_l1_reference`` is its plain PyTorch version. Both take a term as
``sign(w_d)·|q·|w_d| − s·|w_d||`` (each operand scaled by ``|w_d|`` and
rounded once, then one rounded subtract and one rounded add or subtract of
its magnitude: two instructions a term on the card) and sum in ``d`` order
from 0, then ``+ b`` last, so they agree bit for bit; ``(q − s).abs() @ w``
would leave the order to BLAS.

The port's callers: ``pairwise_weighted_l1`` and ``SiameseNet.score_support``
(``T = 1``), the n-shot head scores ``(T, 1, P)`` and the verification pairs
``(P, 1, 1)`` (``ops/distance.head_scores``).

Dispatch is by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel, and a failed build or launch raises. The
kernel has no backward: on the card it is called for scores, under
``torch.no_grad`` or ``torch.inference_mode``. The wrapper does no work
that an input already satisfies (no cast or copy of f32 contiguous
tensors, a scalar f32 ``b`` on the card read in place, no device switch
when the card is current): at the n-shot form its host time is most of the
call.
"""

from __future__ import annotations

import torch

MAX_D = 1024  # the widest embedding the kernel takes
TILE = 128  # output rows and columns of the tiled form's CTA


def weighted_l1_work(T: int, nq: int, ns: int, D: int) -> dict:
    """What the function must do, for its bound: ``bytes`` (q, s, w and b
    read once, the f32 output written once) and ``ops``, two f32
    instructions a term (a subtract of the scaled operands, then an add of
    its magnitude with w's sign; the abs and the sign are operand
    modifiers); ``terms`` = T·nq·ns·D."""
    terms = T * nq * ns * D
    return {"bytes": 4 * (T * nq * D + T * ns * D + D + 1 + T * nq * ns),
            "ops": 2 * terms, "terms": terms}


def _bias(b, device) -> torch.Tensor:
    return torch.as_tensor(b, dtype=torch.float32, device=device).reshape(())


def weighted_l1_reference(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                          b) -> torch.Tensor:
    """Plain PyTorch version → ``(T, nq, ns)`` f32: the kernel's loop over
    ``d``: ``q`` and ``s`` scaled by ``|w_d|`` (one rounding each), their
    difference's magnitude (one rounding) added with the sign of ``w_d``
    (one rounding; the sign is exact), then ``+ b``."""
    qf, sf = q.float(), s.float()
    wf = w.reshape(-1).float()
    wa, sgn = wf.abs(), torch.where(wf < 0, -1.0, 1.0)
    T, nq, D = qf.shape
    acc = torch.zeros((T, nq, sf.shape[1]), dtype=torch.float32, device=qf.device)
    for d in range(D):
        acc = acc + (qf[:, :, None, d] * wa[d] - sf[:, None, :, d] * wa[d]).abs() * sgn[d]
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
    if nq > 1 and (T > 65535 or -(-nq // TILE) > 65535):
        raise ValueError(f"weighted_l1: the tiled form takes T and nq/{TILE} under 65536, "
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
    bt = b if _is_f32(b) and b.numel() == 1 and b.device == q.device else _bias(b, q.device)
    if s.device != q.device or w.device != q.device or bt.device != q.device:
        raise ValueError(f"weighted_l1: every tensor must lie on {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or s.requires_grad or w.requires_grad
                                    or bt.requires_grad):
        raise ValueError("weighted_l1: the B9 kernel has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    qc, sc, wc = _f32_contiguous(q), _f32_contiguous(s), _f32_contiguous(w.reshape(-1))
    T, nq, D = qc.shape
    ns = sc.shape[1]
    out = torch.empty((T, nq, ns), dtype=torch.float32, device=q.device)
    from .._build import check, library

    index = q.device.index
    if index is None or index == torch.cuda.current_device():
        err = _launch(library(), qc, sc, wc, bt, out, T, nq, ns, D)
    else:
        with torch.cuda.device(q.device):
            err = _launch(library(), qc, sc, wc, bt, out, T, nq, ns, D)
    check(err, "weighted_l1")
    weighted_l1.launches += 1
    return out


def _is_f32(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.float32


def _f32_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _launch(lib, q, s, w, b, out, T, nq, ns, D) -> int:
    # The current stream's raw handle, without building a Stream object: at
    # the n-shot form the host's work is most of the call.
    stream = torch._C._cuda_getCurrentRawStream(q.device.index or 0)
    return lib.vm_weighted_l1(q.data_ptr(), s.data_ptr(), w.data_ptr(), b.data_ptr(),
                              out.data_ptr(), T, nq, ns, D, stream)


weighted_l1.launches = 0  # kernel launches; the CPU path does not count
