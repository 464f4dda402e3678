"""K8: the bound-free local round on the variable-row tables.

Replaces ``simgrid_tpu/ops/lmm_jax.py`` ``_vc_round_body``
(``:629-703``), which ``fixpoint_ell`` runs as ``body_local_vc`` for a
local, bound-free system with ``vc_w`` (the headline solve, the churn)
and the compaction chain runs in its stages (``_ell_chain_stage``,
``:736``) and its finisher (``_vc_chunk``, ``:787``).  The CUDA source
is ``csrc/vc_round.cu``.

The JAX round takes its per-constraint sums with scatter-adds over the
[V, Wv] tables, which XLA:CPU applies in update order (row-major over
the table, from 0.0).  The kernel folds each constraint's entries along
the system's constraint-ordered entry layout (``EllSystem.vcx_*``: each
constraint's valid entries in increasing flat position ``v * Wv +
lane``, with their rows, weights and ``w / penalty``), one add at a
time, and never sums with atomics; the scatter-min and scatter-max are
order-free.  Each round also counts the live variables left
(``VLIVE``), which a chain stage's guard reads: a round runs only while
``VLIVE > HALF``.

Two wrappers: :func:`vc_prep` writes what the rounds keep from one to
the next, each constraint's level ``rou`` (in ``Work.rou``) and each
entry's ``w / penalty`` (``vcx_upen``, JAX's ``vc_upen_v``), from the
state and the penalties; it runs before the first round of a solve or
chunk.  :func:`vc_round` runs one round (four kernels) and keeps
``rou`` up to date; it never preps, so its caller runs :func:`vc_prep`
before the first round.

On CPU tensors the wrappers run the plain PyTorch version (a
transcription of the JAX body; ``index_add_`` on the CPU adds in index
order) and return whether they ran; on CUDA tensors they launch the
kernels and return None.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import (IT, LIGHT, VLIVE, D, EllSystem, I, P, Work, check,
                     counter, is_double, on_cpu, ptr_array, stream)
from .ell_round import INF, round_runs
from .superstep_loop import loop_end_args

COUNT = counter("vc_round")
PREP_COUNT = counter("vc_prep")

#: buffers handed to the C entries as one pointer array, in this order
N_PTRS = 19

_SIG = {"vc_round": [I, I, I, I, I, I, P, I, D, P, P, I,
                     ctypes.c_ulonglong, P],
        "vc_prep": [I, I, I, I, P, I, P]}


def group_width(sys: EllSystem) -> int:
    """The lanes a constraint gets in the constraint passes: 8, or 4
    where the layout's mean segment length (its capacity, or the rows'
    slots when fewer, over the constraints) is at most 4.  (The
    headline's first stage and dense table have 24 entries a
    constraint on average.)"""
    nnz = min(int(sys.vcx_row.shape[0]), sys.n_v * sys.wv)
    return 8 if nnz > 4 * max(sys.n_c, 1) else 4


def _rou(light, remaining, usage):
    return torch.where(light, remaining / torch.where(light, usage, 1.0),
                       INF)


def vc_prep_plain(sys: EllSystem, w: Work, pen: torch.Tensor) -> bool:
    w.rou.copy_(_rou(w.light, w.remaining, w.usage))
    n = int(sys.vcx_ptr[-1])
    p = pen[sys.vcx_row[:n].long()]
    sys.vcx_upen[:n] = torch.where(p > 0, sys.vcx_w[:n]
                                   / torch.where(p > 0, p, 1.0), 0.0)
    return True


def vc_round_plain(sys: EllSystem, w: Work, pen: torch.Tensor, eps: float,
                   has_fatpipe: bool = False) -> bool:
    c = w.ctrl
    if not round_runs(c):
        return False
    n_v, n_c = sys.n_v, sys.n_c
    eps_t = torch.tensor(eps, dtype=pen.dtype, device=pen.device)
    vc = sys.vc_cnst.long()
    flat = vc.reshape(-1)
    c_bound = sys.c_bound
    v_value, v_fixed = w.v_value[:n_v], w.v_fixed[:n_v]
    light, remaining, usage = w.light, w.remaining, w.usage
    v_enabled = pen > 0
    vc_evalid = sys.vc_valid & v_enabled[:, None]
    vc_upen_v = (torch.where(vc_evalid, sys.vc_w, 0.0)
                 / torch.where(v_enabled, pen, 1.0)[:, None])

    vc_live = vc_evalid & ~v_fixed[:, None]
    rou = _rou(light, remaining, usage)
    rou_vc = rou[vc]
    nmin_v = torch.where(vc_live, rou_vc, INF).amin(1)
    el_nmin = torch.where(vc_live, nmin_v[:, None], INF)
    nmin_c = torch.full((n_c,), INF, dtype=pen.dtype, device=pen.device) \
        .scatter_reduce_(0, flat, el_nmin.reshape(-1), "amin")
    processable = light & (rou <= nmin_c)
    vc_proc = vc_live & processable[vc]
    level2_v = torch.where(vc_proc, rou_vc, INF).amin(1)
    fix_now = torch.isfinite(level2_v) & ~v_fixed
    new_value = level2_v / torch.where(v_enabled, pen, 1.0)
    v_value_n = torch.where(fix_now, new_value, v_value)
    v_fixed_n = v_fixed | fix_now

    el_fix = vc_live & fix_now[:, None]
    live2 = vc_live & ~fix_now[:, None]
    zeros = torch.zeros(n_c, dtype=pen.dtype, device=pen.device)
    d_rem = zeros.clone().index_add_(0, flat, torch.where(
        el_fix, sys.vc_w * v_value_n[:, None], 0.0).reshape(-1))
    d_use = zeros.clone().index_add_(0, flat, torch.where(
        el_fix, vc_upen_v, 0.0).reshape(-1))
    n_live2 = zeros.clone().index_add_(0, flat,
                                       live2.to(pen.dtype).reshape(-1))
    touched = d_use > 0
    has_live = n_live2 > 0

    new_remaining = remaining - d_rem
    new_remaining = torch.where(new_remaining < c_bound * eps_t, 0.0,
                                new_remaining)
    new_usage_sum = usage - d_use
    new_usage_sum = torch.where(new_usage_sum < eps_t, 0.0, new_usage_sum)
    if has_fatpipe:
        fat = sys.c_fatpipe
        el_upen = torch.where(live2, vc_upen_v, 0.0)
        usage_max = zeros.clone().scatter_reduce_(0, flat,
                                                  el_upen.reshape(-1),
                                                  "amax")
        usage_n = torch.where(touched, torch.where(fat, usage_max,
                                                   new_usage_sum), usage)
        remaining_n = torch.where(touched & ~fat, new_remaining, remaining)
    else:
        usage_n = torch.where(touched, new_usage_sum, usage)
        remaining_n = torch.where(touched, new_remaining, remaining)
    drop = touched & (~(usage_n > eps_t) | ~(remaining_n > c_bound * eps_t))
    light_n = light & ~drop & has_live

    v_value.copy_(v_value_n)
    v_fixed.copy_(v_fixed_n)
    remaining.copy_(remaining_n)
    usage.copy_(usage_n)
    light.copy_(light_n)
    w.rou.copy_(_rou(light_n, remaining_n, usage_n))
    c[IT] = int(c[IT]) + 1
    c[LIGHT] = int(light_n.sum())
    c[VLIVE] = int((~v_fixed_n & v_enabled).sum())
    return True


def _ptrs(sys: EllSystem, w: Work, pen):
    hit = w.ptr_cache.get("vc")
    if hit is not None and hit[0] is sys and hit[1] is pen:
        return hit[2]
    arr = ptr_array([
        pen, sys.vc_cnst, sys.vc_valid, sys.c_bound, sys.c_fatpipe,
        sys.vcx_ptr, sys.vcx_row, sys.vcx_w, sys.vcx_upen, w.v_value,
        w.v_fixed, w.remaining, w.usage, w.light, w.rou, w.nmin_v,
        w.proc, w.vc_code, w.ctrl])
    w.ptr_cache["vc"] = (sys, pen, arr)
    return arr


def vc_prep(sys: EllSystem, w: Work, pen: torch.Tensor):
    """Each constraint's level ``rou`` from the state in ``w`` and each
    entry's ``w / penalty`` into ``sys.vcx_upen``: what the rounds
    read, before the first round of a solve, a chunk or a chain."""
    if on_cpu(pen, sys.vc_w, w.ctrl):
        return vc_prep_plain(sys, w, pen)
    lib = build.load("vc_round", _SIG)
    rc = lib.vc_prep(is_double(pen.dtype), sys.n_v, sys.n_c,
                     int(sys.vcx_row.shape[0]), _ptrs(sys, w, pen), N_PTRS,
                     stream())
    check(rc, "vc_prep")
    PREP_COUNT.n += 1
    return None


def vc_round(sys: EllSystem, w: Work, pen: torch.Tensor, eps: float,
             has_fatpipe: bool = False):
    """One bound-free vc round over the first ``sys.n_v`` variable rows
    of ``w`` (the penalties ``pen`` have that length), skipped once the
    fixpoint converged, spent its round limit or, in a chain stage, has
    no more live variables than the stage keeps.  Reads the ``rou`` and
    ``vcx_upen`` that :func:`vc_prep` wrote before the first round and
    each round keeps.  Captured
    as the body of a ``Loop(..., ends=True)``, the round's last kernel
    ends the loop's iteration (``superstep_loop.loop_end_args``)."""
    if on_cpu(pen, sys.vc_w, w.ctrl):
        return vc_round_plain(sys, w, pen, eps, has_fatpipe)
    lib = build.load("vc_round", _SIG)
    end = loop_end_args()
    rc = lib.vc_round(is_double(pen.dtype), sys.n_v, sys.n_c, sys.wv,
                      group_width(sys), int(has_fatpipe), _ptrs(sys, w, pen),
                      N_PTRS, float(eps),
                      None if end is None else end.cnt,
                      None if end is None else end.tally,
                      0 if end is None else end.cap,
                      0 if end is None else end.handle, stream())
    check(rc, "vc_round")
    COUNT.n += 1
    return None
