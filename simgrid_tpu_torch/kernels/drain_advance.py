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
finite.  ``gated`` runs it inside a superstep advance slot (see the
CUDA source for the STARVED hand-back).
"""

from __future__ import annotations

import torch

from . import build
from .common import (ADV_CONV, ADV_GO, DT, IT, LIGHT, LIMIT, LIVE_ACC,
                     SS_ACTIVE, SS_STARVED, D, I, P, Work, check, counter,
                     is_double, on_cpu, ptr, stream)

COUNT = counter("drain_advance")
FORCED_COUNT = counter("drain_forced_advance")

_SIG = {"drain_advance": [I, I] + [P] * 8 + [I, P],
        "drain_forced_advance": [I, I] + [P] * 6 + [D, P]}


def advance_math(pen, rem, thresh, values):
    """The JAX ``_advance_math`` on tensors: returns (dt, pen2, rem2,
    done).  ``rate*dt`` is one rounded multiply (PyTorch on the CPU does
    not contract it into an FMA)."""
    live = pen > 0
    rate = torch.where(live, values, 0.0)
    flowing = live & (rate > 0)
    inf = torch.tensor(float("inf"), dtype=rem.dtype, device=rem.device)
    dt = torch.min(torch.where(flowing,
                               rem / torch.where(flowing, rate, 1.0), inf))
    rem2 = torch.where(flowing, rem - rate * dt, rem)
    done = flowing & (rem2 < thresh)
    pen2 = torch.where(done, 0.0, pen)
    rem2 = torch.where(done, 0.0, rem2)
    return dt, pen2, rem2, done


def drain_advance_plain(pen: torch.Tensor, rem: torch.Tensor,
                        thresh: torch.Tensor, w: Work,
                        gated: bool = False) -> bool:
    c = w.ctrl
    go = True
    if gated:
        go = bool(int(c[SS_ACTIVE])) and not int(c[SS_STARVED])
        if go and int(c[LIGHT]) > 0 and int(c[IT]) < int(c[LIMIT]):
            c[SS_STARVED] = 1
            go = False
    conv = int(c[LIGHT]) == 0
    c[ADV_GO] = int(go)
    c[ADV_CONV] = int(conv)
    c[LIVE_ACC] = 0
    if not go:
        return False
    if conv:
        dt, pen2, rem2, done = advance_math(pen, rem, thresh, w.v_value)
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
                  thresh: torch.Tensor, w: Work, gated: bool = False):
    """One time advance from the rates in ``w.v_value``."""
    if on_cpu(pen, rem, thresh, w.ctrl):
        return drain_advance_plain(pen, rem, thresh, w, gated)
    lib = build.load("drain_advance", _SIG)
    rc = lib.drain_advance(
        is_double(pen.dtype), int(pen.shape[0]), ptr(pen), ptr(rem),
        ptr(thresh), ptr(w.v_value), ptr(w.done), ptr(w.ctrl),
        ptr(w.fctrl), ptr(w.dtbits), int(gated), stream())
    check(rc, "drain_advance")
    COUNT.n += 1
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
