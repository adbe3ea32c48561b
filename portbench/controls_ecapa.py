"""Controls of the ECAPA-TDNN cell: the program patched to lose precision or
a mechanism, to show that the comparison that decides ``correct`` catches
it. Nothing of the program carries a switch for them; the benchmark's own
runs plant none (``kinds/embed_ecapa.py`` plants ``fp8`` for ``--variant
int8``, the control every cell answers; the others are planted by
``tests/test_portbench_ecapa_card.py`` or a script before ``run.main``).

- ``fp8``: every TDNN's output rounded to float8 e4m3 (a precision below
  the configuration's bf16), on the card's route;
- ``no_se``: the squeeze-excitation gate left out (a gate of ones);
- ``no_hierarchy``: Res2Net's hierarchical add left out (each split
  through its TDNN alone).
"""

from __future__ import annotations

import torch

from voicemap_tpu_torch.models import ecapa

CONTROLS = ("fp8", "no_se", "no_hierarchy")
E4M3_MAX = 448.0


def _fp8(tdnn):
    def rounded(blk, h, cdt, kernel=None):
        out = tdnn(blk, h, cdt, kernel)
        return out.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(out.dtype)
    return rounded


def _no_hierarchy(convs, y, tdnn):
    parts = y.chunk(len(convs) + 1, dim=2)
    return torch.cat([parts[0]] + [tdnn(c, parts[i]) for i, c in enumerate(convs, start=1)],
                     dim=2)


def plant(control: str):
    """Patch the program's ``models/ecapa`` → a function that undoes it."""
    saved = {n: getattr(ecapa, n) for n in ("tdnn_fast", "se_gate", "res2net")}
    fast_tdnn = ecapa.FAST.tdnn
    if control == "fp8":
        ecapa.tdnn_fast = ecapa.FAST.tdnn = _fp8(saved["tdnn_fast"])
    elif control == "no_se":
        ecapa.se_gate = lambda se, y: torch.ones(y.shape[0], y.shape[2], device=y.device)
    elif control == "no_hierarchy":
        ecapa.res2net = _no_hierarchy
    else:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")

    def undo():
        for n, f in saved.items():
            setattr(ecapa, n, f)
        ecapa.FAST.tdnn = fast_tdnn
    return undo
