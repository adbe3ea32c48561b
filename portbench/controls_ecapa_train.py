"""Controls of the ECAPA-TDNN training cell: the program's training forward
patched to lose precision or a mechanism, to show that the comparison that
decides ``correct`` catches it. Nothing of the program carries a switch for
them; the benchmark's own runs plant none (``kinds/train_ecapa.py`` plants
``fp8`` for ``--variant int8``; the other is planted by a test or a script
before ``run.main``). The planted faults of ``faults.py`` (``frozen_state``,
``half_batch``) apply to this cell unchanged.

- ``fp8``: every TDNN's output in the training forward rounded to float8
  e4m3 (a precision below the configuration's bf16), ASP's TDNN included;
  the gradient passes the rounding unchanged;
- ``detached_context``: ASP's global mean and std detached, so that no
  gradient flows through the global context (SpeechBrain passes it).
"""

from __future__ import annotations

import torch

from voicemap_tpu_torch.models import ecapa

CONTROLS = ("fp8", "detached_context")
E4M3_MAX = 448.0


def _rounded(out: torch.Tensor) -> torch.Tensor:
    """``out`` rounded to e4m3 in the forward, the identity in the backward."""
    q = out.detach().clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(out.dtype)
    return out + (q - out.detach())


def plant(control: str):
    """Patch the program's ``models/ecapa`` → a function that undoes it."""
    saved = {n: getattr(ecapa, n) for n in ("tdnn_train", "context_train", "global_stats")}
    if control == "fp8":
        ecapa.tdnn_train = lambda *a: _rounded(saved["tdnn_train"](*a))
        ecapa.context_train = lambda *a: _rounded(saved["context_train"](*a))
    elif control == "detached_context":
        ecapa.global_stats = lambda h: tuple(t.detach() for t in saved["global_stats"](h))
    else:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")

    def undo():
        for n, f in saved.items():
            setattr(ecapa, n, f)
    return undo
