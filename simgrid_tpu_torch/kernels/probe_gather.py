"""K12: the gather ``out[i] = tab[idx[i]]`` of the op-cost probe.

Replaces the gathers of the Pallas probes: P1
``tools/tpu_pallas_probe.py`` ``gk`` (``:59``), P4
``tools/tpu_pallas_gather2.py`` ``buildA``-``buildD``
(``:69/81/93/106``) and P5 ``tools/tpu_pallas_gather3.py`` ``k``
(``:69``), and ``tools/tpu_opcost.py``'s ``gather_flat_E`` and
``gather_2d_V4``.  P4's forms and P5's widths are layouts of the index
(``probes/pallas_gather2.py``, ``probes/pallas_gather3.py``); the
function is the flat gather.  The CUDA source is
``csrc/probe_gather.cu``.

Arms: ``global`` (table reads through the read-only path, one element a
thread) and ``smem`` (the table staged in dynamic shared memory by every
block first; a table larger than a block's opt-in shared memory raises).
Both copy values, so both equal the plain ``tab[idx]`` by bits.  Each
arm counts its launches under ``probe_gather_<arm>``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import I, L, P, check, counter, is_double, on_cpu, ptr, stream

ARMS = ("global", "smem")
COUNTS = {a: counter(f"probe_gather_{a}") for a in ARMS}

_SIG = {"probe_gather": [I, I, L, I, P, P, P, P],
        "probe_gather_smem_limit": [P]}


def probe_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx.long()]


def smem_limit_bytes() -> int:
    """A block's opt-in dynamic shared memory on the current card."""
    lib = build.load("probe_gather", _SIG)
    out = ctypes.c_int(0)
    lib.probe_gather_smem_limit(ctypes.byref(out))
    return int(out.value)


def probe_gather(tab: torch.Tensor, idx: torch.Tensor,
                 arm: str = "global") -> torch.Tensor:
    """``tab[idx]`` for a 1-D float table and an int32 index of any shape
    (each entry in ``[0, len(tab))``); the result is shaped like
    ``idx``."""
    if arm not in ARMS:
        raise ValueError(f"probe_gather arm {arm!r} not in {ARMS}")
    if tab.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("probe_gather takes a 1-D table and an int32 index")
    if on_cpu(tab, idx):
        return probe_gather_plain(tab, idx)
    dbl = is_double(tab.dtype)
    c = int(tab.shape[0])
    if arm == "smem" and c * tab.element_size() > smem_limit_bytes():
        raise ValueError(
            f"the smem arm's table of {c} x {tab.element_size()} B does not "
            f"fit a block's {smem_limit_bytes()} B of shared memory")
    out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
    lib = build.load("probe_gather", _SIG)
    rc = lib.probe_gather(dbl, ARMS.index(arm), idx.numel(), c, ptr(tab),
                          ptr(idx), ptr(out), stream())
    check(rc, f"probe_gather ({arm})")
    COUNTS[arm].n += 1
    return out
