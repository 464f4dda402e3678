"""K1: the fixpoint init and one saturation round, in all of its arms.

Replaces ``simgrid_tpu/ops/lmm_jax.py`` ``fixpoint``: the init
(``lmm_jax.py:436-455``, with the FATPIPE usage max at ``:441-444``),
one ``body_local`` round (``:556-619``, bound-free or with the
bound-first rule of ``:589-619``) or one ``body_global`` round
(``:520-554``, with or without bounds), followed by ``apply_fixes``
(``:469-518``, with or without the FATPIPE branch at ``:490-497``).  The
CUDA source is ``csrc/lmm_round.cu``.

The three flags ``has_bounds``, ``has_fatpipe`` and ``global_rounds``
are arguments, as the JAX program's static arguments are: each caller
decides them the way its JAX counterpart does, so the same round body
runs.  ``vb`` (the per-variable rate bounds) travels beside the
penalties ``pen``; the round reads it only with ``has_bounds``.

A fleet :class:`Work` (``B`` replicas) runs every replica in the same
launch (the replica axis of ``lmm_batch.py``'s vmapped programs):
penalties and bounds are ``[B, ·]``, ``sys.c_bound`` is ``[B, C]``,
``sys.e_w`` and ``vb`` are shared or per replica; the plain version
then runs the solo plain function on each replica in turn.

The kernel walks the constraint rows by a row plan (``lmm_plan``): a
stable partition of the rows by length into long rows (more than
``LONG_ROW`` elements, a block each), medium rows (more than
``SHORT_ROW``, a warp each) and short rows (a thread each), built on the
card from ``csr.c_ptr`` at the first launch on a new row index (system
build, every K4 repack) and kept on the :class:`Work`.  The plan decides
only which threads walk a row, never an order of addition, so the plain
round has no use for it; ``lmm_plan_plain`` is its plain twin.

A round is four kernels (eight with bounds, four or five in global
order), every one after the first a programmatic dependent of the one
before; its last kernel's last block counts the round (``LIGHT``,
``IT``).  Captured as the body of a K16 ``Loop(..., ends=True)`` over
the same control words, that block also evaluates the loop's condition
over every replica, counts the iteration and sets the WHILE node's
handle (``superstep_loop.loop_end_args``), so the body holds no
``loop_cond`` node.

Both wrappers take the system, the fixpoint :class:`Work` and the
penalties.  On CPU tensors they run the plain PyTorch version below (a
line-by-line transcription of the JAX round over the COO elements) and
return whether it ran; on CUDA tensors they launch the kernel and
return None (the device decides whether it runs).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .common import (ARMED, IT, LIGHT, LIGHT_ACC, LIMIT, MAX_ROUNDS,
                     SS_ACTIVE, SS_BUDGET, SS_ROUNDS, D, I, L, LmmSystem, P,
                     Work, check, counter, is_double, on_cpu, ptr,
                     ptr_array, stream)
from .superstep_loop import loop_end_args

INIT_COUNT = counter("lmm_init")
PLAN_COUNT = counter("lmm_plan")

#: arm flags of the C entries (keep in sync with csrc/lmm_round.cu)
ARM_BOUNDS = 1
ARM_FATPIPE = 2
ARM_GLOBAL = 4


def arm_name(flags: int) -> str:
    """The launch counter of one arm: ``lmm_round`` (local, bound-free,
    SHARED only), with ``_global``, ``_bounds``, ``_fatpipe`` added."""
    return ("lmm_round" + ("_global" if flags & ARM_GLOBAL else "")
            + ("_bounds" if flags & ARM_BOUNDS else "")
            + ("_fatpipe" if flags & ARM_FATPIPE else ""))


#: one launch counter per arm combination; a fleet's launches (a
#: :class:`Work` with a replica axis) count under ``<arm>_fleet``
ARM_COUNTS = {f: counter(arm_name(f)) for f in range(8)}
FLEET_ARM_COUNTS = {f: counter(arm_name(f) + "_fleet") for f in range(8)}
COUNT = ARM_COUNTS[0]
FLEET_INIT_COUNT = counter("lmm_init_fleet")

#: buffers handed to the C entries as one pointer array, in this order
N_PTRS = 31

#: the row plan's classes: a row of at most SHORT_ROW elements is walked
#: by one thread, one of more than LONG_ROW by one block, the rest by
#: one warp
SHORT_ROW = 8
LONG_ROW = 256
#: replicas a thread, warp or block of a fleet's launch serves together
#: (0: the kernel chooses 1 or 2 from B and the system's size; 1 or 2
#: forces it, and the C entries refuse any other value)
GROUP = 0

_SIG = {
    "lmm_init": [I, I, I, I, I, P, I, D, I, I, L, I, I, P],
    "lmm_round": [I, I, I, I, I, P, I, D, L, I, I, P, P, I,
                  ctypes.c_ulonglong, P],
    "lmm_plan": [I, I, I, P, P, P, P, P],
}


class RowPlan(NamedTuple):
    """The constraint rows by class: ``order`` [C] int32 lists the long
    rows, then the medium rows, then the short rows, each class in
    increasing row order; ``ncls`` [3] int32 holds the three class
    sizes (long, medium, short)."""
    order: torch.Tensor
    ncls: torch.Tensor


def arm_flags(has_bounds: bool, has_fatpipe: bool,
              global_rounds: bool) -> int:
    return ((ARM_BOUNDS if has_bounds else 0)
            | (ARM_FATPIPE if has_fatpipe else 0)
            | (ARM_GLOBAL if global_rounds else 0))


def _eps(eps: float, ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(eps, dtype=ref.dtype, device=ref.device)


def _full(n: int, val: float, ref: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), val, dtype=ref.dtype, device=ref.device)


def _any_by(index: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(n, bool).at[index].max(mask)``."""
    return torch.zeros(n, dtype=torch.int64, device=mask.device) \
        .index_add_(0, index, mask.long()) > 0


def _min_by(index: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """``full(n, inf).at[index].min(vals)``."""
    return _full(n, float("inf"), vals).scatter_reduce_(0, index, vals,
                                                        "amin")


def _max_by(index: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(n).at[index].max(vals)``."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .scatter_reduce_(0, index, vals, "amax")


def _elements(sys: LmmSystem, pen: torch.Tensor):
    ev, ec, ew = sys.e_var.long(), sys.e_cnst.long(), sys.e_w
    v_enabled = pen > 0
    e_valid = (ew > 0) & v_enabled[ev]
    safe_pen = torch.where(v_enabled, pen, 1.0)
    e_upen = torch.where(e_valid, ew / safe_pen[ev], 0.0)
    return ev, ec, ew, v_enabled, e_valid, e_upen


# ---------------------------------------------------------------------------
# plain PyTorch versions


def lmm_init_plain(sys: LmmSystem, w: Work, pen: torch.Tensor, eps: float,
                   gated: bool = False, limit: int = MAX_ROUNDS,
                   has_fatpipe: bool = False) -> bool:
    c = w.ctrl
    go = int(c[SS_ACTIVE]) if gated else 1
    c[ARMED] = go
    if not go:
        return False
    c[IT] = 0
    c[LIGHT_ACC] = 0
    if gated:
        limit = min(int(c[SS_BUDGET]) - int(c[SS_ROUNDS]), MAX_ROUNDS)
    c[LIMIT] = limit
    eps_t = _eps(eps, pen)
    ev, ec, ew, _, _, e_upen = _elements(sys, pen)
    usage0 = torch.zeros_like(sys.c_bound).index_add_(0, ec, e_upen)
    if has_fatpipe:
        usage0 = torch.where(sys.c_fatpipe,
                             _max_by(ec, e_upen, sys.n_c), usage0)
    w.v_value.copy_(torch.where(torch.isfinite(pen), pen, 0.0) * 0.0)
    w.v_fixed.copy_(pen < 0)
    w.remaining.copy_(sys.c_bound)
    w.usage.copy_(usage0)
    w.light.copy_((sys.c_bound > sys.c_bound * eps_t) & (usage0 > 0))
    c[LIGHT] = int(w.light.sum())
    return True


def _body_local(sys, w, pen, vb, eps_t, has_bounds, rou, ev, ec,
                v_enabled, e_live):
    """``body_local``: (fix_now, new_value)."""
    n_c, n_v = sys.n_c, sys.n_v
    inf = float("inf")
    v_fixed = w.v_fixed

    # two-hop neighbourhood min of rou: constraint -> vars -> constraint
    e_rou = torch.where(e_live, rou[ec], inf)
    nmin_v = _min_by(ev, e_rou, n_v)
    e_nmin = torch.where(e_live, nmin_v[ev], inf)
    nmin_c = _min_by(ec, e_nmin, n_c)
    processable = w.light & (rou <= nmin_c)
    e_proc = e_live & processable[ec]
    w.nmin_v.copy_(nmin_v)
    w.proc.copy_(processable)
    safe = torch.where(v_enabled, pen, 1.0)

    if not has_bounds:
        level2_v = _min_by(ev, torch.where(e_proc, e_rou, inf), n_v)
        fix_now = torch.isfinite(level2_v) & ~v_fixed
        return fix_now, level2_v / safe

    # the bound-first rule, localised (lmm_jax.py:589-619)
    v_sat = _any_by(ev, e_proc, n_v)
    level_v = nmin_v
    bp = vb * pen
    low_v = v_sat & (vb > 0) & (bp < level_v)
    e_bp = torch.where(e_live & low_v[ev], bp[ev], inf)
    mb_c = _min_by(ec, e_bp, n_c)
    mb_c = torch.where(processable, mb_c, inf)
    e_mb = torch.where(e_proc, mb_c[ec], inf)
    mb_v = _min_by(ev, e_mb, n_v)
    e_blocked = e_proc & torch.isfinite(mb_v[ev])
    blocked_c = _any_by(ec, e_blocked, n_c)
    ok_c = processable & ~blocked_c
    e_rou_ok = torch.where(e_live & ok_c[ec], rou[ec], inf)
    level2_v = _min_by(ev, e_rou_ok, n_v)
    fix_bound = low_v & (torch.abs(bp - mb_v) < eps_t)
    fix_level = torch.isfinite(level2_v) & ~v_fixed & ~fix_bound
    for name, t in (("low_v", low_v), ("mb_v", mb_v), ("level2_v", level2_v),
                    ("mb_c", mb_c), ("blocked_c", blocked_c)):
        getattr(w, name).copy_(t)
    return fix_bound | fix_level, torch.where(fix_bound, vb,
                                              level2_v / safe)


def _body_global(sys, w, pen, vb, eps_t, has_bounds, rou, ev, ec,
                 v_enabled, e_live):
    """``body_global``: (fix_now, new_value)."""
    min_usage = torch.min(rou)
    saturated_c = w.light & (rou == min_usage)
    e_sat = e_live & saturated_c[ec]
    v_sat = _any_by(ev, e_sat, sys.n_v)
    w.rou.copy_(rou)
    safe = torch.where(v_enabled, pen, 1.0)
    if not has_bounds:
        return v_sat, min_usage / safe
    # the bound-first rule (lmm_jax.py:541-554)
    bp = vb * pen
    has_low_bound = v_sat & (vb > 0) & (bp < min_usage)
    min_bound = torch.min(torch.where(has_low_bound, bp, float("inf")))
    if bool(torch.isfinite(min_bound)):
        return v_sat & (torch.abs(bp - min_bound) < eps_t), vb
    return v_sat, min_usage / safe


def lmm_round_plain(sys: LmmSystem, w: Work, pen: torch.Tensor,
                    eps: float, vb: Optional[torch.Tensor] = None,
                    has_bounds: bool = False, has_fatpipe: bool = False,
                    global_rounds: bool = False) -> bool:
    c = w.ctrl
    if not (int(c[ARMED]) and int(c[LIGHT]) > 0
            and int(c[IT]) < int(c[LIMIT])):
        return False
    n_c = sys.n_c
    eps_t = _eps(eps, pen)
    ev, ec, ew, v_enabled, e_valid, e_upen = _elements(sys, pen)
    light, remaining, usage = w.light, w.remaining, w.usage
    rou = torch.where(light, remaining / torch.where(light, usage, 1.0),
                      float("inf"))
    e_live = e_valid & ~w.v_fixed[ev]
    body = _body_global if global_rounds else _body_local
    fix_now, new_value = body(sys, w, pen, vb, eps_t, has_bounds, rou, ev,
                              ec, v_enabled, e_live)

    # apply_fixes
    v_value = torch.where(fix_now, new_value, w.v_value)
    v_fixed = w.v_fixed | fix_now
    e_fix = e_valid & fix_now[ev]
    zeros = torch.zeros_like(remaining)
    d_rem = zeros.clone().index_add_(
        0, ec, torch.where(e_fix, ew * v_value[ev], 0.0))
    d_use = zeros.clone().index_add_(0, ec, torch.where(e_fix, e_upen, 0.0))
    new_remaining = remaining - d_rem
    new_remaining = torch.where(new_remaining < sys.c_bound * eps_t, 0.0,
                                new_remaining)
    new_usage = usage - d_use
    new_usage = torch.where(new_usage < eps_t, 0.0, new_usage)
    e_live2 = e_valid & ~v_fixed[ev]
    touched = _any_by(ec, e_fix, n_c)
    if has_fatpipe:
        fat = sys.c_fatpipe
        new_usage_max = _max_by(ec, torch.where(e_live2, e_upen, 0.0), n_c)
        usage_n = torch.where(touched, torch.where(fat, new_usage_max,
                                                   new_usage), usage)
        remaining_n = torch.where(touched & ~fat, new_remaining, remaining)
    else:
        usage_n = torch.where(touched, new_usage, usage)
        remaining_n = torch.where(touched, new_remaining, remaining)
    drop = touched & (~(usage_n > eps_t)
                      | ~(remaining_n > sys.c_bound * eps_t))
    has_live = _any_by(ec, e_live2, n_c)
    light_n = light & ~drop & has_live

    w.fix_now.copy_(fix_now)
    w.v_value.copy_(v_value)
    w.v_fixed.copy_(v_fixed)
    w.remaining.copy_(remaining_n)
    w.usage.copy_(usage_n)
    w.light.copy_(light_n)
    c[IT] = int(c[IT]) + 1
    c[LIGHT] = int(light_n.sum())
    return True


def lmm_plan_plain(c_ptr: torch.Tensor, short_max: int = SHORT_ROW,
                   long_min: int = LONG_ROW) -> RowPlan:
    n = (c_ptr[1:] - c_ptr[:-1]).long()
    long_ = n > long_min
    med = (n > short_max) & ~long_
    short = ~(long_ | med)
    order = torch.cat([torch.nonzero(m).reshape(-1)
                       for m in (long_, med, short)])
    ncls = torch.stack([long_.sum(), med.sum(), short.sum()])
    return RowPlan(order.to(torch.int32), ncls.to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers


def lmm_plan(c_ptr: torch.Tensor, short_max: int = SHORT_ROW,
             long_min: int = LONG_ROW) -> RowPlan:
    """The row plan of a constraint row index ``c_ptr`` [C+1], built on
    the device that holds it, with no host sync."""
    if short_max < 0 or long_min < short_max:
        raise ValueError(f"row classes need 0 <= short_max <= long_min "
                         f"({short_max}, {long_min})")
    if on_cpu(c_ptr):
        return lmm_plan_plain(c_ptr, short_max, long_min)
    lib = build.load("lmm_round", _SIG)
    C = int(c_ptr.shape[0]) - 1
    dev = c_ptr.device
    order = torch.empty(C, dtype=torch.int32, device=dev)
    ncls = torch.empty(3, dtype=torch.int32, device=dev)
    # flags 2C bytes, then int32 exl[C] exm[C] bsum[C / 2048 + 1] tot[2]
    n_int = 2 * C + C // 2048 + 3
    scratch = torch.empty(((2 * C + 15) & ~15) + 4 * n_int,
                          dtype=torch.uint8, device=dev)
    rc = lib.lmm_plan(C, int(short_max), int(long_min), ptr(c_ptr),
                      ptr(order), ptr(ncls), ptr(scratch), stream())
    check(rc, "lmm_plan")
    PLAN_COUNT.n += 1
    return RowPlan(order, ncls)


def plan_of(sys: LmmSystem, w: Work) -> RowPlan:
    """The row plan of ``sys``'s row index, built at the first launch on
    it and kept on ``w`` (one plan: a new index replaces it)."""
    hit = w.k1_plan
    if hit is None or hit[0] is not sys.csr:
        hit = w.k1_plan = (sys.csr, lmm_plan(sys.csr.c_ptr, SHORT_ROW,
                                             LONG_ROW))
    return hit[1]


def _ptrs(sys: LmmSystem, w: Work, pen, vb, flags: int):
    """The pointer array of one (system, work, penalties, bounds, arms)
    tuple, built once and kept on ``w``: a solve's chunks and every
    capture of K16's loops call the round over the same buffers, and
    building 28 checked pointers per call is host time.  Arms without
    bounds key on ``vb=None`` whatever the caller passed, so that the
    init (which never reads bounds) and a bound-free round share one
    entry."""
    if flags & ARM_BOUNDS and vb is None:
        raise ValueError("the bound arm needs the rate bounds vb")
    if not flags & ARM_BOUNDS:
        vb = None
    hit = w.ptr_cache.get(flags)
    if hit is not None and hit[0] is sys and hit[1] is pen \
            and hit[2] is vb:
        return hit[3]
    csr = sys.csr
    if flags & ARM_FATPIPE and sys.c_fatpipe is None:
        raise ValueError("the FATPIPE arm needs sys.c_fatpipe")
    plan = plan_of(sys, w)
    arr = ptr_array([
        pen, vb, sys.e_var, sys.e_cnst,
        sys.e_w, sys.c_bound,
        sys.c_fatpipe if flags & ARM_FATPIPE else None,
        csr.c_ptr, csr.c_idx, csr.v_ptr, csr.v_idx, w.v_value, w.v_fixed,
        w.remaining, w.usage, w.light, w.nmin_v, w.proc, w.fix_now,
        w.low_v, w.mb_v, w.level2_v, w.mb_c, w.blocked_c, w.rou,
        w.min_usage, w.min_bound, w.ctrl, plan.order, plan.ncls, w.touch])
    # the tuple holds sys, pen, vb and the plan, so their ids cannot be
    # reused and the plan's buffers outlive the pointers
    w.ptr_cache[flags] = (sys, pen, vb, arr, plan)
    return arr


def _strides(sys: LmmSystem, w: Work, pen: torch.Tensor,
             vb: Optional[torch.Tensor]):
    """The per-replica strides of ``e_w``, ``c_bound`` and ``vb`` (0:
    shared), after checking a fleet's shapes."""
    if w.B is None:
        return 0, 0, 0
    B, V, C = w.B, sys.n_v, sys.n_c
    if tuple(pen.shape) != (B, V):
        raise ValueError(f"fleet penalties must be [{B}, {V}]")
    for name, t, n in (("e_w", sys.e_w, sys.n_e), ("c_bound", sys.c_bound,
                                                   C), ("vb", vb, V)):
        if t is not None and t.dim() == 2 and tuple(t.shape) != (B, n):
            raise ValueError(f"fleet {name} must be [{n}] or [{B}, {n}]")
    per = lambda t, n: n if t is not None and t.dim() == 2 else 0  # noqa
    return per(sys.e_w, sys.n_e), per(sys.c_bound, C), per(vb, V)


def lmm_init(sys: LmmSystem, w: Work, pen: torch.Tensor, eps: float,
             gated: bool = False, limit: int = MAX_ROUNDS,
             has_fatpipe: bool = False) -> Optional[bool]:
    """Initialise the fixpoint state from the system and penalties.
    ``gated`` runs it only in an active superstep advance slot and takes
    the round limit from the superstep's remaining budget."""
    if on_cpu(pen, sys.e_w, w.ctrl):
        if w.B is not None:
            return any([lmm_init_plain(sys.replica(b), w.replica(b), pen[b],
                                       eps, gated, limit, has_fatpipe)
                        for b in range(w.B)])
        return lmm_init_plain(sys, w, pen, eps, gated, limit, has_fatpipe)
    lib = build.load("lmm_round", _SIG)
    flags = arm_flags(False, has_fatpipe, False)
    s_ew, s_cb, _ = _strides(sys, w, pen, None)
    rc = lib.lmm_init(is_double(pen.dtype), w.nb, sys.n_v, sys.n_c,
                      flags | GROUP << 8,
                      _ptrs(sys, w, pen, None, flags), N_PTRS, float(eps),
                      int(gated), int(limit), s_ew, s_cb, 0, stream())
    check(rc, "lmm_init")
    (INIT_COUNT if w.B is None else FLEET_INIT_COUNT).n += 1
    return None


def lmm_round(sys: LmmSystem, w: Work, pen: torch.Tensor, eps: float,
              vb: Optional[torch.Tensor] = None, has_bounds: bool = False,
              has_fatpipe: bool = False,
              global_rounds: bool = False) -> Optional[bool]:
    """One saturation round (local unless ``global_rounds``), skipped
    when the fixpoint has converged or spent its round limit; a fleet's
    plain version returns whether any replica ran.  Captured as the
    body of a ``Loop(..., ends=True)``, whose condition must read
    ``w.ctrl``, the round's last kernel ends the loop's iteration."""
    if on_cpu(pen, sys.e_w, w.ctrl):
        if w.B is not None:
            return any([lmm_round_plain(
                sys.replica(b), w.replica(b), pen[b], eps,
                None if vb is None else (vb[b] if vb.dim() == 2 else vb),
                has_bounds, has_fatpipe, global_rounds)
                for b in range(w.B)])
        return lmm_round_plain(sys, w, pen, eps, vb, has_bounds,
                               has_fatpipe, global_rounds)
    lib = build.load("lmm_round", _SIG)
    flags = arm_flags(has_bounds, has_fatpipe, global_rounds)
    s_ew, s_cb, s_vb = _strides(sys, w, pen,
                                vb if flags & ARM_BOUNDS else None)
    end = loop_end_args()
    if end is not None and not (
            end.ctrl is not None and end.ctrl.data_ptr() == w.ctrl.data_ptr()
            and end.ctrl.numel() == w.ctrl.numel()):
        raise ValueError("K1 ends a loop only over its own control words")
    rc = lib.lmm_round(is_double(pen.dtype), w.nb, sys.n_v, sys.n_c,
                       flags | GROUP << 8,
                       _ptrs(sys, w, pen, vb, flags), N_PTRS, float(eps),
                       s_ew, s_cb, s_vb,
                       None if end is None else end.cnt,
                       None if end is None else end.tally,
                       0 if end is None else end.cap,
                       0 if end is None else end.handle, stream())
    check(rc, "lmm_round")
    (ARM_COUNTS if w.B is None else FLEET_ARM_COUNTS)[flags].n += 1
    return None
