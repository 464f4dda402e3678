"""K5: scatter one payload of indexed runs into a list of device arrays.

Replaces two programs of the JAX package that compute the same thing:
``simgrid_tpu/ops/lmm_drain.py`` ``_apply_transition_payload``
(``:552-581``, the drain's transition batch) and
``simgrid_tpu/ops/lmm_warm.py`` ``_apply_deltas`` (``:119-137``, the
warm solver's delta upload into its seven resident masters).  The CUDA
source is ``csrc/transition_scatter.cu``.

The payload is one float64 vector of per-field runs
``[indices..., values...]``; ``layout`` lists ``(target, offset, n)``
per run, the target being an index into the caller's target list
(:data:`TRANSITION_FIELDS` for the drain, :data:`DELTA_FIELDS` for the
warm solver).  Indices travel as float64 (exact below 2^32) and are
truncated to int; values are cast to the target's dtype (truncation for
int32, round to nearest for float32, nonzero for bool, as
``astype(bool)``).  The JAX programs return new arrays; here the targets
are updated in place.  The drain ships exact runs; the warm solver pads
each run as JAX does, repeating its first (index, value) pair, which
writes the same value twice and changes nothing.

The callers count their launches apart: :func:`transition_scatter`
under ``transition_scatter``, :func:`delta_scatter` under
``delta_scatter``, and :func:`ell_delta_scatter` (``lmm_warm.py``
``_apply_deltas_ell``, ``:140-154``: one element-delta batch into the
six ELL masters, flattened ``row * width + lane`` indexes) under
``delta_scatter_ell``.  Its two validity targets take the "positive"
kind: ``valid = weight > 0``, as the JAX program writes them, where the
bool kind would write ``weight != 0``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import build
from .common import (I, P, LaunchCounter, check, counter, on_cpu, ptr,
                     ptr_array, stream)

COUNT = counter("transition_scatter")
DELTA_COUNT = counter("delta_scatter")
ELL_COUNT = counter("delta_scatter_ell")

#: transition-payload field order (the JAX package's _TRANSITION_FIELDS)
TRANSITION_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "v_penalty",
                     "remains", "thresh", "v_bound")
#: warm-solver master order (the JAX package's lmm_warm._FIELDS)
DELTA_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "c_fatpipe",
                "v_penalty", "v_bound")
#: the warm solver's ELL master order (the JAX package's ``st.ell``)
ELL_FIELDS = ("cv_var", "cv_w", "cv_valid", "vc_cnst", "vc_valid", "vc_w")
#: the ELL masters whose runs write ``value > 0`` (the validity tables)
ELL_POSITIVE = (2, 4)

_SIG = {"transition_scatter": [I, P, P, P, P, I, P]}

#: target kinds of the C entry
_KIND = {torch.int32: 0, torch.float32: 1, torch.float64: 2, torch.bool: 3}
#: a bool target written as ``value > 0``
_KIND_POSITIVE = 4

Layout = Sequence[Tuple[int, int, int]]


def transition_scatter_plain(payload: torch.Tensor, layout: Layout,
                             targets: List[torch.Tensor],
                             positive: Tuple[int, ...] = ()) -> bool:
    for ti, off, n in layout:
        idx = payload[off:off + n].to(torch.int64)
        vals = payload[off + n:off + 2 * n]
        t = targets[ti]
        t.view(-1)[idx] = (vals > 0) if ti in positive else vals.to(t.dtype)
    return True


def _scatter(payload: torch.Tensor, layout: Layout,
             targets: List[torch.Tensor], fields: Tuple[str, ...],
             count: LaunchCounter, positive: Tuple[int, ...] = ()):
    if payload.dtype != torch.float64:
        raise TypeError("the scatter payload is float64")
    if len(targets) != len(fields):
        raise ValueError(f"{len(fields)} targets expected")
    used = [targets[ti] for ti, _, _ in layout]
    if on_cpu(payload, *used):
        return transition_scatter_plain(payload, layout, targets, positive)
    for t in used:
        if t.dtype not in _KIND:
            raise TypeError(f"scatter target of dtype {t.dtype}")
    lib = build.load("transition_scatter", _SIG)
    runs = (ctypes.c_int * (3 * len(layout)))(
        *(int(x) for run in layout for x in run))
    kinds = (ctypes.c_int * len(targets))(
        *(_KIND_POSITIVE if ti in positive else _KIND.get(t.dtype, -1)
          for ti, t in enumerate(targets)))
    rc = lib.transition_scatter(len(layout), runs, ptr(payload),
                                ptr_array(targets), kinds, len(targets),
                                stream())
    check(rc, "transition_scatter")
    count.n += 1
    return None


def transition_scatter(payload: torch.Tensor, layout: Layout,
                       targets: List[torch.Tensor]):
    """Scatter every run of a drain transition payload into ``targets``
    (one tensor per entry of :data:`TRANSITION_FIELDS`), in place."""
    return _scatter(payload, layout, targets, TRANSITION_FIELDS, COUNT)


def delta_scatter(payload: torch.Tensor, layout: Layout,
                  targets: List[torch.Tensor]):
    """Scatter every run of a warm-solver delta payload into the
    resident masters (one tensor per entry of :data:`DELTA_FIELDS`), in
    place."""
    return _scatter(payload, layout, targets, DELTA_FIELDS, DELTA_COUNT)


def ell_delta_scatter(payload: torch.Tensor, layout: Layout,
                      targets: List[torch.Tensor]):
    """Scatter one element-delta batch into the six ELL masters (one
    tensor per entry of :data:`ELL_FIELDS`, indexed flat), in place; the
    validity masters get ``value > 0``."""
    for ti in ELL_POSITIVE:
        if targets[ti].dtype != torch.bool:
            raise TypeError("the ELL validity masters are bool")
    return _scatter(payload, layout, targets, ELL_FIELDS, ELL_COUNT,
                    ELL_POSITIVE)
