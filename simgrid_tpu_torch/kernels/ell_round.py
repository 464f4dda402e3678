"""K7: the ELL fixpoint's init and one saturation round on the
constraint-row tables.

Replaces ``simgrid_tpu/ops/lmm_jax.py`` ``fixpoint_ell`` (``:198-388``)
as ``_solve_ell_chunk`` (``:944-966``) runs it: the None-carry init
(``:219-241``: ``cv_upen``, ``usage0`` as the row sum or, on a FATPIPE
row, the row max, ``light0``, ``cv_live0``), ``apply_fixes``
(``:252-299``), ``body_global`` (``:301-323``) and ``body_local``
(``:325-367``, the bound-first rule on the cv/vc tables).  The
bound-free local round of a system with ``vc_w`` is K8
(:mod:`.vc_round`), as ``fixpoint_ell`` picks ``body_local_vc`` there.
The CUDA source is ``csrc/ell_round.cu``.

Every row sum of the cv tables (``usage0``, ``d_rem``, ``d_use``)
folds as XLA:CPU folds ``x.sum(axis=1)``: windows of 32 consecutive
lanes (the row padded with zeros to a multiple of 32, half of them on
the left) left to right from 0.0, then the window partials left to
right (:func:`fold_rows`); minima, maxima and ORs are order-free.

What a solve keeps fixed is written once a chunk by :func:`ell_prep`
(a K16 step at the head of the chunk's graph, before its round loop):
each cv entry's ``w / penalty`` into ``EllWork.cv_upen`` (JAX's
``cv_upen``: 0 where the entry is not enabled), whether it is enabled
into ``EllWork.cv_ev``, and each constraint's level ``rou``; the init
writes all three too and every round keeps ``rou`` up to date, so a
round may follow the init at once.  State that another kernel wrote
(K6's warm start) needs :func:`ell_prep` before the first round, which
:func:`~..ops.lmm_torch.chunk_loop` runs at every chunk's head.  Captured as the body
of a ``Loop(..., ends=True)``, the round's last kernel ends the loop's
iteration (``superstep_loop.loop_end_args``).

On CPU tensors the wrappers run the plain PyTorch version (a
transcription of the JAX program, which keeps ``rou`` and the tables
as the kernels do) and return whether it ran; on CUDA tensors they launch
the kernel and return None.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .common import (ARMED, HALF, IT, LIGHT, LIGHT_ACC, LIMIT, MAX_ROUNDS,
                     NFIXED_ACC, OVERFLOW, VLIVE, VLIVE_ACC, D, EllSystem,
                     EllWork, I, P, check, counter, is_double, on_cpu,
                     ptr_array, stream)
from .superstep_loop import loop_end_args

INIT_COUNT = counter("ell_init")
PREP_COUNT = counter("ell_prep")
LOCAL_COUNT = counter("ell_round")
GLOBAL_COUNT = counter("ell_round_global")

#: arm flags of the C entries (keep in sync with csrc/ell_round.cu)
ARM_FATPIPE = 2
ARM_GLOBAL = 4

#: buffers handed to the C entries as one pointer array, in this order
N_PTRS = 28

_SIG = {
    "ell_init": [I, I, I, I, I, P, I, D, I, P],
    "ell_prep": [I, I, I, I, I, P, I, P],
    "ell_round": [I, I, I, I, I, I, P, I, D, P, P, I, ctypes.c_ulonglong,
                  P],
}

INF = float("inf")


def fold_rows(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a [R, W] table in XLA:CPU's order for ``sum(axis=1)``
    at any width W: a row of at most 32 lanes is folded left to right
    from 0.0; a wider row is padded with zeros to a multiple of 32,
    ``pad // 2`` of them on the left, each window of 32 lanes is folded
    left to right from 0.0 and the window partials are summed the same
    way, recursively (XLA's tree reduction: a reduce-window of 32, then
    the reduce).  (Within some fused programs LLVM reassociates a
    32-lane window into 4-lane vectors; those widths are not held by
    bits, ROADMAP C2.)"""
    r, wdt = x.shape
    if wdt <= 32:
        total = torch.zeros(r, dtype=x.dtype, device=x.device)
        for j in range(wdt):
            total = total + x[:, j]
        return total
    padded = -(-wdt // 32) * 32
    low = (padded - wdt) // 2
    xp = torch.zeros((r, padded), dtype=x.dtype, device=x.device)
    xp[:, low:low + wdt] = x
    parts = torch.stack([fold_rows(xp[:, b:b + 32])
                         for b in range(0, padded, 32)], 1)
    return fold_rows(parts)


def row_max0(x: torch.Tensor) -> torch.Tensor:
    """``x.max(axis=1, initial=0.0)``."""
    return torch.clamp_min(x.amax(1), 0.0)


def arm_ctrl(ctrl: torch.Tensor, light: torch.Tensor, limit: int) -> None:
    """Arm the control words of a fresh fixpoint (plain versions)."""
    ctrl[IT] = 0
    ctrl[LIGHT_ACC] = 0
    ctrl[ARMED] = 1
    ctrl[LIMIT] = limit
    ctrl[HALF] = -1
    ctrl[VLIVE] = 0
    ctrl[VLIVE_ACC] = 0
    ctrl[OVERFLOW] = 0
    ctrl[NFIXED_ACC] = 0
    ctrl[LIGHT] = int(light.sum())


def round_runs(ctrl: torch.Tensor) -> bool:
    """The guard every round reads first (plain versions): armed, a
    light constraint left, the round limit not spent, and (in a chain
    stage) more live variables than the stage keeps."""
    return bool(int(ctrl[ARMED]) and int(ctrl[LIGHT]) > 0
                and int(ctrl[IT]) < int(ctrl[LIMIT])
                and int(ctrl[VLIVE]) > int(ctrl[HALF]))


def _rou(light, remaining, usage):
    return torch.where(light, remaining / torch.where(light, usage, 1.0),
                       INF)


def _cv_upen(sys: EllSystem, pen: torch.Tensor):
    cv_var = sys.cv_var.long()
    v_enabled = pen > 0
    cv_evalid = sys.cv_valid & v_enabled[cv_var]
    safe_pen = torch.where(v_enabled, pen, 1.0)
    cv_upen = torch.where(cv_evalid, sys.cv_w / safe_pen[cv_var], 0.0)
    return cv_var, v_enabled, cv_evalid, cv_upen


# ---------------------------------------------------------------------------
# plain PyTorch versions


def ell_init_plain(sys: EllSystem, w: EllWork, pen: torch.Tensor,
                   eps: float, limit: int = MAX_ROUNDS) -> bool:
    eps_t = torch.tensor(eps, dtype=pen.dtype, device=pen.device)
    cv_var, _, cv_evalid, cv_upen = _cv_upen(sys, pen)
    usage0 = torch.where(sys.c_fatpipe, row_max0(cv_upen),
                         fold_rows(cv_upen))
    v_fixed0 = pen < 0
    w.v_value.copy_(torch.where(torch.isfinite(pen), pen, 0.0) * 0.0)
    w.v_fixed.copy_(v_fixed0)
    w.remaining.copy_(sys.c_bound)
    w.usage.copy_(usage0)
    w.light.copy_((sys.c_bound > sys.c_bound * eps_t) & (usage0 > 0))
    w.cv_live.copy_(cv_evalid & ~v_fixed0[cv_var])
    w.cv_upen.copy_(cv_upen)
    w.cv_ev.copy_(cv_evalid)
    w.rou.copy_(_rou(w.light, w.remaining, w.usage))
    arm_ctrl(w.ctrl, w.light, limit)
    return True


def ell_prep_plain(sys: EllSystem, w: EllWork, pen: torch.Tensor) -> bool:
    _, _, cv_evalid, cv_upen = _cv_upen(sys, pen)
    w.cv_upen.copy_(cv_upen)
    w.cv_ev.copy_(cv_evalid)
    w.rou.copy_(_rou(w.light, w.remaining, w.usage))
    return True


def _body_local(sys, w, pen, vb, eps_t, rou, v_enabled):
    """``body_local``: (fix_now, new_value)."""
    vc = sys.vc_cnst.long()
    cv_var = sys.cv_var.long()
    v_fixed = w.v_fixed
    vc_live = sys.vc_valid & v_enabled[:, None] & ~v_fixed[:, None]
    cv_live = w.cv_live
    rou_vc = rou[vc]
    nmin_v = torch.where(vc_live, rou_vc, INF).amin(1)
    nmin_c = torch.where(cv_live, nmin_v[cv_var], INF).amin(1)
    processable = w.light & (rou <= nmin_c)
    vc_proc = vc_live & processable[vc]
    v_sat = vc_proc.any(1)
    bp = vb * pen
    low_v = v_sat & (vb > 0) & (bp < nmin_v)
    cv_bp = torch.where(cv_live & low_v[cv_var], bp[cv_var], INF)
    mb_c = torch.where(processable, cv_bp.amin(1), INF)
    mb_v = torch.where(vc_proc, mb_c[vc], INF).amin(1)
    cv_proc = cv_live & processable[:, None]
    blocked_c = (cv_proc & torch.isfinite(mb_v[cv_var])).any(1)
    ok_c = processable & ~blocked_c
    level2_v = torch.where(vc_live & ok_c[vc], rou_vc, INF).amin(1)
    fix_bound = low_v & (torch.abs(bp - mb_v) < eps_t)
    fix_level = torch.isfinite(level2_v) & ~v_fixed & ~fix_bound
    return fix_bound | fix_level, torch.where(
        fix_bound, vb, level2_v / torch.where(v_enabled, pen, 1.0))


def _body_global(sys, w, pen, vb, eps_t, rou, v_enabled):
    """``body_global``: (fix_now, new_value)."""
    vc = sys.vc_cnst.long()
    min_usage = torch.min(rou)
    saturated_c = w.light & (rou == min_usage)
    vc_live = sys.vc_valid & v_enabled[:, None] & ~w.v_fixed[:, None]
    v_sat = (vc_live & saturated_c[vc]).any(1)
    bp = vb * pen
    has_low_bound = v_sat & (vb > 0) & (bp < min_usage)
    min_bound = torch.min(torch.where(has_low_bound, bp, INF))
    if bool(torch.isfinite(min_bound)):
        return v_sat & (torch.abs(bp - min_bound) < eps_t), vb
    return v_sat, min_usage / torch.where(v_enabled, pen, 1.0)


def ell_round_plain(sys: EllSystem, w: EllWork, pen: torch.Tensor,
                    eps: float, vb: torch.Tensor, has_fatpipe: bool = False,
                    global_rounds: bool = False) -> bool:
    c = w.ctrl
    if not round_runs(c):
        return False
    eps_t = torch.tensor(eps, dtype=pen.dtype, device=pen.device)
    light, remaining, usage = w.light, w.remaining, w.usage
    c_bound = sys.c_bound
    rou = _rou(light, remaining, usage)
    cv_var, v_enabled, cv_evalid, cv_upen = _cv_upen(sys, pen)
    body = _body_global if global_rounds else _body_local
    fix_now, new_value = body(sys, w, pen, vb, eps_t, rou, v_enabled)

    # apply_fixes
    v_value = torch.where(fix_now, new_value, w.v_value)
    v_fixed = w.v_fixed | fix_now
    g_value, g_fixed = v_value[cv_var], v_fixed[cv_var]
    cv_fix = w.cv_live & g_fixed
    d_rem = fold_rows(torch.where(cv_fix, sys.cv_w * g_value, 0.0))
    d_use = fold_rows(torch.where(cv_fix, cv_upen, 0.0))
    new_remaining = remaining - d_rem
    new_remaining = torch.where(new_remaining < c_bound * eps_t, 0.0,
                                new_remaining)
    new_usage_sum = usage - d_use
    new_usage_sum = torch.where(new_usage_sum < eps_t, 0.0, new_usage_sum)
    cv_live2 = cv_evalid & ~g_fixed
    touched = cv_fix.any(1)
    if has_fatpipe:
        fat = sys.c_fatpipe
        new_usage = torch.where(
            fat, row_max0(torch.where(cv_live2, cv_upen, 0.0)),
            new_usage_sum)
        usage_n = torch.where(touched, new_usage, usage)
        remaining_n = torch.where(touched & ~fat, new_remaining, remaining)
    else:
        usage_n = torch.where(touched, new_usage_sum, usage)
        remaining_n = torch.where(touched, new_remaining, remaining)
    drop = touched & (~(usage_n > eps_t) | ~(remaining_n > c_bound * eps_t))
    light_n = light & ~drop & cv_live2.any(1)

    w.v_value.copy_(v_value)
    w.v_fixed.copy_(v_fixed)
    w.remaining.copy_(remaining_n)
    w.usage.copy_(usage_n)
    w.light.copy_(light_n)
    w.cv_live.copy_(cv_live2)
    w.rou.copy_(_rou(light_n, remaining_n, usage_n))
    c[IT] = int(c[IT]) + 1
    c[LIGHT] = int(light_n.sum())
    return True


# ---------------------------------------------------------------------------
# wrappers


def _ptrs(sys: EllSystem, w: EllWork, pen, vb):
    """The pointer array of one (system, work, penalties, bounds) tuple,
    built once and kept on ``w`` (a fixpoint calls its rounds over the
    same buffers)."""
    hit = w.ptr_cache.get("ell")
    if hit is not None and hit[0] is sys and hit[1] is pen \
            and hit[2] is vb:
        return hit[3]
    arr = ptr_array([
        pen, vb, sys.cv_var, sys.cv_w, sys.cv_valid, sys.vc_cnst,
        sys.vc_valid, sys.c_bound, sys.c_fatpipe, w.v_value, w.v_fixed,
        w.remaining, w.usage, w.light, w.cv_live, w.nmin_v, w.proc,
        w.fix_now, w.low_v, w.mb_v, w.mb_c, w.blocked_c, w.rou,
        w.min_usage, w.min_bound, w.ctrl, w.cv_upen, w.cv_ev])
    w.ptr_cache["ell"] = (sys, pen, vb, arr)
    return arr


def ell_init(sys: EllSystem, w: EllWork, pen: torch.Tensor, eps: float,
             vb: torch.Tensor, limit: int = MAX_ROUNDS):
    """The None-carry init of ``fixpoint_ell`` into ``w``, with the
    control words armed for ``limit`` rounds."""
    if on_cpu(pen, sys.cv_w, w.ctrl):
        return ell_init_plain(sys, w, pen, eps, limit)
    lib = build.load("ell_round", _SIG)
    rc = lib.ell_init(is_double(pen.dtype), sys.n_v, sys.n_c, sys.wc,
                      sys.wv, _ptrs(sys, w, pen, vb), N_PTRS, float(eps),
                      int(limit), stream())
    check(rc, "ell_init")
    INIT_COUNT.n += 1
    return None


def ell_prep(sys: EllSystem, w: EllWork, pen: torch.Tensor,
             vb: Optional[torch.Tensor] = None):
    """Each constraint's level ``rou`` from the state in ``w``, each cv
    entry's ``w / penalty`` into ``w.cv_upen`` and whether it is enabled
    into ``w.cv_ev``: what the rounds read, before the first round of a
    solve or chunk.  ``vb`` (not read) is the rounds' own, so that they
    share one pointer array."""
    if on_cpu(pen, sys.cv_w, w.ctrl):
        return ell_prep_plain(sys, w, pen)
    lib = build.load("ell_round", _SIG)
    rc = lib.ell_prep(is_double(pen.dtype), sys.n_v, sys.n_c, sys.wc,
                      sys.wv, _ptrs(sys, w, pen, vb), N_PTRS, stream())
    check(rc, "ell_prep")
    PREP_COUNT.n += 1
    return None


def ell_round(sys: EllSystem, w: EllWork, pen: torch.Tensor, eps: float,
              vb: torch.Tensor, has_fatpipe: bool = False,
              global_rounds: bool = False):
    """One ``body_local`` (with the bound-first rule) or ``body_global``
    round and its ``apply_fixes``, skipped once the fixpoint converged or
    spent its round limit.  ``vb`` are the variables' rate bounds (-1:
    none), which both bodies read.  Reads the ``rou``, ``cv_upen`` and
    ``cv_ev`` that the init or :func:`ell_prep` wrote before the first
    round (each round keeps ``rou``)."""
    if on_cpu(pen, sys.cv_w, w.ctrl):
        return ell_round_plain(sys, w, pen, eps, vb, has_fatpipe,
                               global_rounds)
    lib = build.load("ell_round", _SIG)
    flags = ((ARM_FATPIPE if has_fatpipe else 0)
             | (ARM_GLOBAL if global_rounds else 0))
    end = loop_end_args()
    rc = lib.ell_round(is_double(pen.dtype), sys.n_v, sys.n_c, sys.wc,
                       sys.wv, flags, _ptrs(sys, w, pen, vb), N_PTRS,
                       float(eps), None if end is None else end.cnt,
                       None if end is None else end.tally,
                       0 if end is None else end.cap,
                       0 if end is None else end.handle, stream())
    check(rc, "ell_round")
    (GLOBAL_COUNT if global_rounds else LOCAL_COUNT).n += 1
    return None
