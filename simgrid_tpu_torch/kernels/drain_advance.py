"""K2: the drain's dt/retire step, and its forced mode.

Replaces ``simgrid_tpu/ops/lmm_drain.py`` ``_advance_math`` with
``_rounded_product`` (``:147-189``) and ``_drain_advance``
(``:192-200``), and in forced mode ``_drain_forced_advance``
(``:584-603``): the same retirement at a delta the host gives instead of
the min dt.  The CUDA source is ``csrc/drain_advance.cu``.

The step reads the rates the fixpoint left in ``w.v_value`` and updates
``pen``/``rem`` in place, writes the completion mask into ``w.done``, dt
into ``w.fctrl[DT]`` and the live count into ``w.ctrl[LIVE_ACC]``.  It
changes the flow state only when the fixpoint converged and dt is
finite.  ``gated`` runs it only where the replica's superstep advance
slot is active (``SS_ACTIVE``): in a superstep, after K16's round loop,
and in the fleet's fused rescue.

The event arm (``tape_t``, the fault tape's f64 dates, and/or
``ready``, a collective's f64 activation dates) replaces the superstep
body's ``has_tape or has_coll`` branch (``:363-401``): it peeks the
next event against the clock ``w.evf[EV_T0] + t_sum`` (or ``t_sum``
with a collective), clamps dt to land on it, and leaves ``FIRE``,
``FFIRE``, ``AANY`` in ``w.ctrl`` and the event date in
``w.evf[EV_NEXT_T]`` for K3.

With a fleet :class:`Work` (``B`` replicas; ``pen``, ``rem``,
``thresh`` ``[B, V]``, ``tape_t`` ``[B, T]``) one launch advances every
replica, each against its own control words, minima and clock
(``lmm_batch.py``'s vmapped superstep and fused rescue,
``_batch_fused_fresh``/``_cont``).  The plain version runs the solo
plain step on each replica in turn.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .common import (AANY, ADV_CONV, ADV_GO, ADV_OK, DT, EV_NEXT_T, EV_T0,
                     FFIRE, FIRE, LIGHT, LIVE_ACC, SS_ACTIVE, T_SUM, TPOS,
                     D, I, P, Work, check, counter, is_double, on_cpu,
                     opt_ptr, ptr, stream)

COUNT = counter("drain_advance")
FORCED_COUNT = counter("drain_forced_advance")
EVENT_COUNT = counter("drain_advance_event")
FLEET_COUNT = counter("drain_advance_fleet")
FLEET_EVENT_COUNT = counter("drain_advance_event_fleet")

_SIG = {"drain_advance": [I, I, I] + [P] * 8 + [I, P, P, P, I, P, P],
        "drain_forced_advance": [I, I] + [P] * 6 + [D, P]}


def planned_dt(pen, rem, values):
    """dt to the next completion, ``min rem / rate`` over flowing flows
    (the front half of the JAX ``_advance_math``), with the rates."""
    live = pen > 0
    rate = torch.where(live, values, 0.0)
    flowing = live & (rate > 0)
    inf = torch.tensor(float("inf"), dtype=rem.dtype, device=rem.device)
    dt = torch.min(torch.where(flowing,
                               rem / torch.where(flowing, rate, 1.0), inf))
    return dt, rate, flowing


def retire(pen, rem, thresh, rate, flowing, dt):
    """``rem - rate*dt`` (one rounded multiply: PyTorch on the CPU does
    not contract it into an FMA) and the strict-< retirement."""
    rem2 = torch.where(flowing, rem - rate * dt, rem)
    done = flowing & (rem2 < thresh)
    pen2 = torch.where(done, 0.0, pen)
    rem2 = torch.where(done, 0.0, rem2)
    return pen2, rem2, done


def advance_math(pen, rem, thresh, values):
    """The JAX ``_advance_math`` on tensors: returns (dt, pen2, rem2,
    done)."""
    dt, rate, flowing = planned_dt(pen, rem, values)
    return (dt,) + retire(pen, rem, thresh, rate, flowing, dt)


def event_peek(w: Work, dt_plan: torch.Tensor,
               tape_t: Optional[torch.Tensor],
               ready: Optional[torch.Tensor]) -> torch.Tensor:
    """The event peek and the clamp of the superstep body
    (``lmm_drain.py:375-396``), in f64 Python floats (IEEE round to
    nearest, as JAX's f64 ops): returns the advance's dt and leaves
    FIRE/FFIRE/AANY and the event date in the control words."""
    c = w.ctrl
    inf = float("inf")
    tpos = int(c[TPOS])
    next_ft = (float(tape_t[tpos]) if tape_t is not None
               and tpos < tape_t.shape[0] else inf)
    next_at = (float(ready.min()) if ready is not None
               and ready.numel() else inf)
    ts = float(w.fctrl[T_SUM])
    now = ts if ready is not None else float(w.evf[EV_T0]) + ts
    next_t = next_at if next_at < next_ft else next_ft
    fire = math.isfinite(next_t) and next_t <= now + float(dt_plan)
    c[FIRE] = int(fire)
    c[FFIRE] = int(fire and next_ft <= next_at)
    c[AANY] = int(fire and next_at <= next_ft)
    w.evf[EV_NEXT_T] = next_t
    if not fire:
        return dt_plan
    gap = next_t - now
    return torch.tensor(0.0 if gap < 0.0 else gap,
                        dtype=torch.float64).to(dt_plan.dtype)


def drain_advance_plain(pen: torch.Tensor, rem: torch.Tensor,
                        thresh: torch.Tensor, w: Work,
                        gated: bool = False,
                        tape_t: Optional[torch.Tensor] = None,
                        ready: Optional[torch.Tensor] = None) -> bool:
    c = w.ctrl
    go = bool(int(c[SS_ACTIVE])) if gated else True
    conv = int(c[LIGHT]) == 0
    c[ADV_GO] = int(go)
    c[ADV_CONV] = int(conv)
    c[LIVE_ACC] = 0
    for slot in (ADV_OK, FIRE, FFIRE, AANY):
        c[slot] = 0
    if not go:
        return False
    if conv:
        dt, rate, flowing = planned_dt(pen, rem, w.v_value)
        if tape_t is not None or ready is not None:
            dt = event_peek(w, dt, tape_t, ready)
        pen2, rem2, done = retire(pen, rem, thresh, rate, flowing, dt)
    else:
        dt = torch.tensor(float("inf"), dtype=pen.dtype)
        pen2, rem2, done = pen, rem, torch.zeros_like(w.done)
    ok = conv and bool(torch.isfinite(dt))
    w.fctrl[DT] = dt
    if ok:
        pen.copy_(pen2)
        rem.copy_(rem2)
        w.done.copy_(done)
    else:
        w.done.zero_()
    c[LIVE_ACC] = int((pen > 0).sum())
    return True


def drain_advance(pen: torch.Tensor, rem: torch.Tensor,
                  thresh: torch.Tensor, w: Work, gated: bool = False,
                  tape_t: Optional[torch.Tensor] = None,
                  ready: Optional[torch.Tensor] = None):
    """One time advance from the rates in ``w.v_value``; with
    ``tape_t`` and/or ``ready`` (f64) the event arm clamps it to the
    next fault date or activation date."""
    event = tape_t is not None or ready is not None
    extra = [t for t in (tape_t, ready) if t is not None]
    if on_cpu(pen, rem, thresh, w.ctrl, *extra):
        if w.B is not None:
            return any([drain_advance_plain(
                pen[b], rem[b], thresh[b], w.replica(b), gated,
                None if tape_t is None else tape_t[b],
                None if ready is None else ready[b])
                for b in range(w.B)])
        return drain_advance_plain(pen, rem, thresh, w, gated, tape_t,
                                   ready)
    if w.B is not None:
        for t in (pen, rem, thresh, ready):
            if t is not None and tuple(t.shape) != tuple(w.v_value.shape):
                raise ValueError("fleet flow state must be [B, V]")
        if tape_t is not None and tape_t.shape[0] != w.B:
            raise ValueError("fleet tape dates must be [B, T]")
    lib = build.load("drain_advance", _SIG)
    rc = lib.drain_advance(
        is_double(pen.dtype), w.nb, int(pen.shape[-1]), ptr(pen), ptr(rem),
        ptr(thresh), ptr(w.v_value), ptr(w.done), ptr(w.ctrl),
        ptr(w.fctrl), ptr(w.dtbits), int(bool(gated)), ptr(w.evf),
        ptr(w.atbits), opt_ptr(tape_t),
        0 if tape_t is None else int(tape_t.shape[-1]), opt_ptr(ready),
        stream())
    check(rc, "drain_advance")
    if w.B is None:
        (EVENT_COUNT if event else COUNT).n += 1
    else:
        (FLEET_EVENT_COUNT if event else FLEET_COUNT).n += 1
    return None


def drain_forced_advance_plain(pen: torch.Tensor, rem: torch.Tensor,
                               thresh: torch.Tensor, w: Work,
                               delta: float) -> bool:
    """``_drain_forced_advance``: decrement the remains of flowing flows
    by ``rate * delta`` (one rounded multiply, then the subtraction) and
    retire those strictly below their threshold.  The caller solved to
    convergence first; the step runs unconditionally."""
    d = torch.tensor(delta, dtype=rem.dtype, device=rem.device)
    live = pen > 0
    rate = torch.where(live, w.v_value, 0.0)
    flowing = live & (rate > 0)
    rem2 = torch.where(flowing, rem - rate * d, rem)
    done = flowing & (rem2 < thresh)
    pen.copy_(torch.where(done, 0.0, pen))
    rem.copy_(torch.where(done, 0.0, rem2))
    w.done.copy_(done)
    w.ctrl[LIVE_ACC] = int((pen > 0).sum())
    return True


def drain_forced_advance(pen: torch.Tensor, rem: torch.Tensor,
                         thresh: torch.Tensor, w: Work, delta: float):
    """Advance by the given ``delta`` at the rates in ``w.v_value``:
    updates ``pen``/``rem`` in place, the completion mask into
    ``w.done`` and the live count into ``w.ctrl[LIVE_ACC]``."""
    if on_cpu(pen, rem, thresh, w.ctrl):
        return drain_forced_advance_plain(pen, rem, thresh, w, delta)
    lib = build.load("drain_advance", _SIG)
    rc = lib.drain_forced_advance(
        is_double(pen.dtype), int(pen.shape[0]), ptr(pen), ptr(rem),
        ptr(thresh), ptr(w.v_value), ptr(w.done), ptr(w.ctrl),
        float(delta), stream())
    check(rc, "drain_forced_advance")
    FORCED_COUNT.n += 1
    return None
