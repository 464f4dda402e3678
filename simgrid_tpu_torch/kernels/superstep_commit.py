"""K3: superstep control, the Kahan clock and the completion ring.

Replaces ``simgrid_tpu/ops/lmm_drain.py`` ``_superstep_program``
(``:248-531``) and the commit half of ``_fused_step_program``
(``:203-234``).  The CUDA source is ``csrc/superstep_commit.cu``; the
while_loop itself and its condition run on the card as K16
(``superstep_loop.py``).

The commit's two event arms follow K2's event peek: the fault-tape arm
(``tape=(tape_slot, tape_val)`` and the drain's ``c_bound``) logs the
fired entry, scatters its bound and bumps the cursor; the collective
arm (``ready``, ``pen``) fires the activations.  Every call (two CUDA
launches) counts once: as ``superstep_commit_coll`` when its collective
arm is on (with or without the tape arm, whose runs show in the fault
events it logs), as ``superstep_commit_tape`` when only its tape arm is
on, as ``superstep_commit`` otherwise; a fleet's calls count under the
same names with ``_fleet`` appended.

``packed`` is the superstep's result vector in the JAX layout:
``[rounds, adv, n_ev, t_sum, n_live, flag, live_elems]``, then
``adv_dt[k_max]``, ``adv_nev[k_max]``, ``ring_t[ring_n]``,
``ring_id[ring_n]``, all in the drain's dtype.

A fleet :class:`Work` (``B`` replicas, the replica axis of
``lmm_batch.py``'s ``_batch_superstep_program``) runs every replica in
the same launches: ``superstep_reset`` takes per-replica ``k`` (0 for
a dead replica, whose guards are then false from entry), ``t0`` and
``tpos`` as ``[B]`` tensors (and a collective's ``ready`` ``[B, V]``
and Kahan pairs ``clk`` ``[B, 2]``), and ``packed`` is ``[B,
packed_size]``.  The plain versions run the solo plain function
on each replica in turn.
"""

from __future__ import annotations

import math

import torch

from . import build
from typing import Optional, Tuple

from .common import (AANY, ADV_CONV, ADV_GO, ADV_OK, DT, EV_NEXT_T, EV_T0,
                     FFIRE, FLAG_BUDGET, FLAG_OK, FLAG_STALLED, IT, LE_ACC,
                     LIVE_ACC, PENDING, SS_ACTIVE, SS_ADV, SS_BUDGET,
                     SS_FLAG, SS_K, SS_NEV, SS_NLIVE, SS_ROUNDS, SS_STOP,
                     T_COMP, T_SUM, TPOS, D, I, L, P, Work, check, counter,
                     is_double, on_cpu, opt_ptr, ptr, stream)

COUNT = counter("superstep_commit")
TAPE_COUNT = counter("superstep_commit_tape")
COLL_COUNT = counter("superstep_commit_coll")
RESET_COUNT = counter("superstep_reset")
FINISH_COUNT = counter("superstep_finish")
#: a fleet's launches (a Work with a replica axis)
FLEET_COUNT = counter("superstep_commit_fleet")
FLEET_TAPE_COUNT = counter("superstep_commit_tape_fleet")
FLEET_COLL_COUNT = counter("superstep_commit_coll_fleet")
FLEET_RESET_COUNT = counter("superstep_reset_fleet")
FLEET_FINISH_COUNT = counter("superstep_finish_fleet")

_SIG = {
    "superstep_reset": [I, I, I, P, P, P, I, I, I, P, D, I, P, P, P, P, P,
                        P],
    "superstep_commit": [I, I, I, P, P, P, P, P, I, I, P, P, P, I, P, I, I,
                         P, P, P, P],
    "superstep_finish": [I, I, I, I, P, P, L, P, P, L, P, P, P, P],
}

#: the fault-tape arm's device arrays: constraint slots (int32) and new
#: bounds (the drain's dtype)
Tape = Tuple[torch.Tensor, torch.Tensor]

N_STATS = 7


def packed_size(k_max: int, ring_n: int) -> int:
    return N_STATS + 2 * k_max + 2 * ring_n


def _lib():
    return build.load("superstep_commit", _SIG)


# ---------------------------------------------------------------------------
# plain PyTorch versions


def superstep_reset_plain(pen, w: Work, k: int, budget: int, stop: int,
                          t0: float = 0.0, tpos: int = 0,
                          ready: Optional[torch.Tensor] = None,
                          clk: Optional[torch.Tensor] = None) -> None:
    c = w.ctrl
    pending = 0 if ready is None else int(torch.isfinite(ready).sum())
    for slot, val in ((SS_ACTIVE, 0), (SS_ADV, 0), (SS_ROUNDS, 0),
                      (SS_FLAG, FLAG_OK), (SS_NEV, 0), (SS_K, k),
                      (SS_BUDGET, budget), (SS_STOP, stop),
                      (TPOS, tpos), (PENDING, pending),
                      (ADV_OK, 0)):
        c[slot] = val
    c[SS_NLIVE] = int((pen > 0).sum())
    w.fctrl[T_SUM] = 0.0 if clk is None else clk[0]
    w.fctrl[T_COMP] = 0.0 if clk is None else clk[1]
    w.evf[EV_T0] = t0
    w.evf[EV_NEXT_T] = float("inf")


def superstep_commit_plain(w: Work, ids: torch.Tensor, packed: torch.Tensor,
                           k_max: int, ring_n: int,
                           tape: Optional[Tape] = None,
                           c_bound: Optional[torch.Tensor] = None,
                           n_c: int = 0,
                           ready: Optional[torch.Tensor] = None,
                           pen: Optional[torch.Tensor] = None) -> bool:
    c = w.ctrl
    if not int(c[ADV_GO]):
        return False
    f = w.fctrl
    dt = f[DT]
    conv = bool(int(c[ADV_CONV]))
    finite = math.isfinite(float(dt))
    ok = conv and finite
    y = dt - f[T_COMP]
    t_new = f[T_SUM] + y
    t_comp2 = (t_new - f[T_SUM]) - y
    n_ev = int(c[SS_NEV])
    adv = int(c[SS_ADV])
    n_act = 0
    if ok:
        o = N_STATS + 2 * k_max
        done = w.done
        dcount = torch.cumsum(done.to(torch.int64), 0)
        n_done = int(dcount[-1]) if dcount.numel() else 0
        pos = (n_ev + dcount - 1)[done]
        packed[o + pos] = t_new
        packed[o + ring_n + pos] = ids[done].to(packed.dtype)
        n_new = n_ev + n_done
        if tape is not None and int(c[FFIRE]):
            # the fault fires after this advance's completions
            tpos = int(c[TPOS])
            slot = int(tape[0][tpos])
            packed[o + n_new] = t_new
            packed[o + ring_n + n_new] = -(1 + slot)
            c_bound[slot] = tape[1][tpos]
            c[TPOS] = tpos + 1
            n_new += 1
        if ready is not None and int(c[AANY]):
            # activations after completions and the fault entry
            act = ready <= float(w.evf[EV_NEXT_T])
            acount = torch.cumsum(act.to(torch.int64), 0)
            n_act = int(acount[-1]) if acount.numel() else 0
            apos = (n_new + acount - 1)[act]
            packed[o + apos] = t_new
            packed[o + ring_n + apos] = (-(1 + n_c) - ids[act].to(
                torch.int64)).to(packed.dtype)
            pen[act] = 1.0
            ready[act] = float("inf")
            c[PENDING] = int(c[PENDING]) - n_act
            n_new += n_act
        packed[N_STATS + adv] = dt
        packed[N_STATS + k_max + adv] = n_new
        f[T_SUM] = t_new
        f[T_COMP] = t_comp2
        c[SS_NEV] = n_new
        c[SS_ADV] = adv + 1
    c[ADV_OK] = int(ok)
    c[SS_ROUNDS] = int(c[SS_ROUNDS]) + int(c[IT])
    c[SS_FLAG] = (FLAG_BUDGET if not conv
                  else FLAG_OK if finite else FLAG_STALLED)
    c[SS_NLIVE] = int(c[LIVE_ACC]) + n_act
    return True


def superstep_finish_plain(e_var, e_w, pen, packed: torch.Tensor,
                           w: Work, clk: Optional[torch.Tensor] = None
                           ) -> None:
    c = w.ctrl
    live_elems = int(((e_w > 0) & (pen[e_var.long()] > 0)).sum())
    c[LE_ACC] = live_elems
    flag = int(c[SS_FLAG])
    packed[:N_STATS] = torch.tensor(
        [int(c[SS_ROUNDS]), int(c[SS_ADV]), int(c[SS_NEV]), 0.0,
         int(c[SS_NLIVE]), flag, live_elems], dtype=packed.dtype)
    packed[3] = w.fctrl[T_SUM]
    if clk is not None:
        clk[0] = w.fctrl[T_SUM]
        clk[1] = w.fctrl[T_COMP]


# ---------------------------------------------------------------------------
# wrappers


def _host(x, b):
    """Replica ``b``'s value of a per-replica argument (a [B] tensor or
    sequence) or the scalar every replica shares."""
    if isinstance(x, torch.Tensor):
        return x[b].item()
    if isinstance(x, (list, tuple)):
        return x[b]
    return x


def superstep_reset(pen, w: Work, k, budget: int, stop: int,
                    t0=0.0, tpos=0,
                    ready: Optional[torch.Tensor] = None,
                    clk: Optional[torch.Tensor] = None) -> None:
    """The superstep's loop carry; ``t0`` (the f64 host clock the event
    peek adds ``t_sum`` to: a float, or a float64 ``[1]`` tensor on the
    drain's device, which a speculative superstep derives on the card)
    and ``tpos`` (the tape cursor) for a fault tape, ``ready`` (pending activation dates) and ``clk`` (the carried
    f64 Kahan pair) for a collective.  For a fleet, ``k``, ``t0`` and
    ``tpos`` are per replica: int32, float64 and int32 ``[B]`` tensors
    on the fleet's device (or scalars every replica shares)."""
    extra = [t for t in (ready, clk) if t is not None]
    arrs = [x for x in (k, t0, tpos) if isinstance(x, torch.Tensor)]
    if on_cpu(pen, w.ctrl, *extra, *arrs):
        if w.B is not None:
            for b in range(w.B):
                superstep_reset_plain(
                    pen[b], w.replica(b), int(_host(k, b)), budget, stop,
                    float(_host(t0, b)), int(_host(tpos, b)),
                    None if ready is None else ready[b],
                    None if clk is None else clk[b])
            return None
        return superstep_reset_plain(pen, w, k, budget, stop, t0, tpos,
                                     ready, clk)
    if w.B is not None:
        if tuple(pen.shape[:1]) != (w.B,):
            raise ValueError("fleet penalties must be [B, V]")
        for x, dt in ((k, torch.int32), (t0, torch.float64),
                      (tpos, torch.int32)):
            if isinstance(x, torch.Tensor) and (x.dtype != dt or tuple(
                    x.shape) != (w.B,)):
                raise ValueError(f"fleet k/t0/tpos must be [B] {dt}")
        if (ready is not None and ready.shape != pen.shape) or (
                clk is not None and tuple(clk.shape) != (w.B, 2)):
            raise ValueError("a collective fleet's ready is [B, V] and its "
                             "clock pairs [B, 2]")
    arr = lambda x: x if isinstance(x, torch.Tensor) else None  # noqa
    scal = lambda x, d: d if isinstance(x, torch.Tensor) else x  # noqa
    rc = _lib().superstep_reset(
        is_double(pen.dtype), w.nb, int(pen.shape[-1]), ptr(pen), ptr(w.ctrl),
        ptr(w.fctrl), int(scal(k, 0)), int(budget), int(stop), ptr(w.evf),
        float(scal(t0, 0.0)), int(scal(tpos, 0)), opt_ptr(ready),
        opt_ptr(clk), opt_ptr(arr(k)), opt_ptr(arr(t0)), opt_ptr(arr(tpos)),
        stream())
    check(rc, "superstep_reset")
    (RESET_COUNT if w.B is None else FLEET_RESET_COUNT).n += 1


def superstep_commit(w: Work, ids: torch.Tensor, packed: torch.Tensor,
                     k_max: int, ring_n: int, tape: Optional[Tape] = None,
                     c_bound: Optional[torch.Tensor] = None, n_c: int = 0,
                     ready: Optional[torch.Tensor] = None,
                     pen: Optional[torch.Tensor] = None):
    """Commit the advance K2 just computed into the superstep carry; with
    ``tape`` the fired fault entry (bound into ``c_bound``), with
    ``ready``/``pen`` the fired activations (ring ids offset by
    ``n_c``).  A fleet's ``packed``, tape rows, ``c_bound``, ``ready``
    and ``pen`` are per replica (``[B, ·]``); the ids are shared."""
    extra = [t for t in (*(tape or ()), c_bound, ready, pen)
             if t is not None]
    if on_cpu(w.ctrl, ids, packed, *extra):
        if w.B is not None:
            ts, tv = tape if tape is not None else (None, None)
            return any([superstep_commit_plain(
                w.replica(b), ids, packed[b], k_max, ring_n,
                None if tape is None else (ts[b], tv[b]),
                None if c_bound is None else c_bound[b], n_c,
                None if ready is None else ready[b],
                None if pen is None else pen[b]) for b in range(w.B)])
        return superstep_commit_plain(w, ids, packed, k_max, ring_n, tape,
                                      c_bound, n_c, ready, pen)
    ts, tv = tape if tape is not None else (None, None)
    if w.B is not None and tuple(packed.shape) != (
            w.B, packed_size(k_max, ring_n)):
        raise ValueError("fleet packed must be [B, packed_size]")
    cb = c_bound if tape is not None else None
    if w.B is not None and cb is not None and (cb.dim() != 2
                                               or cb.shape[0] != w.B):
        raise ValueError("a fleet's tape arm scatters into [B, C] bounds")
    rc = _lib().superstep_commit(
        is_double(packed.dtype), w.nb, int(w.done.shape[-1]), ptr(w.done),
        ptr(ids), ptr(packed), ptr(w.ctrl), ptr(w.fctrl), int(k_max),
        int(ring_n), ptr(w.evf), opt_ptr(ts), opt_ptr(tv),
        0 if ts is None else int(ts.shape[-1]), opt_ptr(cb),
        0 if cb is None else int(cb.shape[-1]), int(n_c),
        opt_ptr(ready), opt_ptr(pen if ready is not None else None),
        ptr(w.commit_scan), stream())
    check(rc, "superstep_commit")
    plain, taped, coll = ((COUNT, TAPE_COUNT, COLL_COUNT) if w.B is None
                          else (FLEET_COUNT, FLEET_TAPE_COUNT,
                                FLEET_COLL_COUNT))
    (coll if ready is not None else taped if tape is not None
     else plain).n += 1
    return None


def superstep_finish(e_var, e_w, pen, packed: torch.Tensor, w: Work,
                     clk: Optional[torch.Tensor] = None) -> None:
    """Live elements and the packed stats; with a collective, the Kahan
    pair back into ``clk``.  A fleet's ``e_w`` is shared or ``[B, E]``."""
    extra = [clk] if clk is not None else []
    if on_cpu(e_var, pen, packed, *extra):
        if w.B is not None:
            for b in range(w.B):
                superstep_finish_plain(
                    e_var, e_w[b] if e_w.dim() == 2 else e_w, pen[b],
                    packed[b], w.replica(b),
                    None if clk is None else clk[b])
            return None
        return superstep_finish_plain(e_var, e_w, pen, packed, w, clk)
    s_ew = int(e_w.shape[-1]) if e_w.dim() == 2 else 0
    rc = _lib().superstep_finish(
        is_double(packed.dtype), w.nb, int(e_var.shape[0]),
        int(pen.shape[-1]), ptr(e_var), ptr(e_w), s_ew, ptr(pen),
        ptr(packed), int(packed.shape[-1]), ptr(w.ctrl), ptr(w.fctrl),
        opt_ptr(clk), stream())
    check(rc, "superstep_finish")
    (FINISH_COUNT if w.B is None else FLEET_FINISH_COUNT).n += 1
