"""K5: scatter one transition payload into the drain's device arrays.

Replaces ``simgrid_tpu/ops/lmm_drain.py`` ``_apply_transition_payload``
(``:552-581``).  The CUDA source is ``csrc/transition_scatter.cu``.

The payload is one float64 vector of per-field runs
``[indices..., values...]``; ``layout`` lists ``(target, offset, n)``
per run, the target being an index into :data:`TRANSITION_FIELDS`.
Indices travel as float64 (exact below 2^32) and are truncated to int;
values are cast to the target's dtype (truncation for the int32 element
arrays, round to nearest for float32).  Element targets are the flat
element arrays, so an element slot is the JAX package's
``row * group + column``.  The JAX program returns new arrays; here the
targets are updated in place.  Runs are exact (no padding): JAX pads a
run by repeating its first (index, value) pair, which writes the same
value twice and changes nothing.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import build
from .common import (I, P, check, counter, on_cpu, ptr, ptr_array,
                     stream)

COUNT = counter("transition_scatter")

#: transition-payload field order (the JAX package's _TRANSITION_FIELDS)
TRANSITION_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "v_penalty",
                     "remains", "thresh", "v_bound")

_SIG = {"transition_scatter": [I, P, P, P, P, P]}

#: target kinds of the C entry
_KIND = {torch.int32: 0, torch.float32: 1, torch.float64: 2}


def transition_scatter_plain(payload: torch.Tensor,
                             layout: Sequence[Tuple[int, int, int]],
                             targets: List[torch.Tensor]) -> bool:
    for ti, off, n in layout:
        idx = payload[off:off + n].to(torch.int64)
        vals = payload[off + n:off + 2 * n]
        t = targets[ti]
        t[idx] = vals.to(t.dtype)
    return True


def transition_scatter(payload: torch.Tensor,
                       layout: Sequence[Tuple[int, int, int]],
                       targets: List[torch.Tensor]):
    """Scatter every run of ``payload`` into ``targets`` (one tensor per
    entry of :data:`TRANSITION_FIELDS`), in place."""
    if payload.dtype != torch.float64:
        raise TypeError("the transition payload is float64")
    if len(targets) != len(TRANSITION_FIELDS):
        raise ValueError(f"{len(TRANSITION_FIELDS)} targets expected")
    used = [targets[ti] for ti, _, _ in layout]
    if on_cpu(payload, *used):
        return transition_scatter_plain(payload, layout, targets)
    for t in used:
        if t.dtype not in _KIND:
            raise TypeError(f"transition target of dtype {t.dtype}")
    lib = build.load("transition_scatter", _SIG)
    runs = (ctypes.c_int * (3 * len(layout)))(
        *(int(x) for run in layout for x in run))
    kinds = (ctypes.c_int * len(targets))(
        *(_KIND.get(t.dtype, -1) for t in targets))
    rc = lib.transition_scatter(len(layout), runs, ptr(payload),
                                ptr_array(targets), kinds, stream())
    check(rc, "transition_scatter")
    COUNT.n += 1
    return None
