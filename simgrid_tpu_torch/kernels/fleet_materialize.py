"""K11: a fleet's per-replica state, materialised on the card.

Replaces ``simgrid_tpu/ops/lmm_batch.py`` ``_materialize``
(``:390-407``) and ``_materialize_ew`` (``:375-388``) at the fleet's
birth, and ``_admit_lane_state`` (``:409-437``), ``_admit_lane_tape``
(``:440-449``) and ``_admit_lane_ew`` (``:463-470``) when one replica is
admitted into row ``b`` of a live fleet.  The CUDA source is
``csrc/fleet_materialize.cu``; birth and admission run the same kernels
over the whole fleet or over the one row.

The arithmetic is ``derive_replica_arrays``'s, in its order and in f64:
``base * scale`` first, then the sparse factors; dead flows get penalty
0; thresholds are ``done_eps * size`` (``done_mode`` "rel") or
``done_eps``; then the cast to the fleet's dtype.  Payload rows come
from ``ops/lmm_batch._pack_overrides``/``_pack_elem_w``: index arrays
padded with an out-of-range slot (dropped) and factors padded with 1.0.

On CPU tensors each wrapper runs its plain version (one replica at a
time: ``tensor[b].copy_`` and indexed assignment); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import build
from .common import (D, I, L, P, check, counter, is_double, on_cpu, ptr,
                     ptr_array, stream)

STATE_COUNT = counter("fleet_materialize")
EW_COUNT = counter("fleet_materialize_ew")
ADMIT_COUNT = counter("fleet_admit")
ADMIT_EW_COUNT = counter("fleet_admit_ew")
ADMIT_TAPE_COUNT = counter("fleet_admit_tape")

_SIG = {
    "fleet_state": [I, I, I, I, I, P, I, I, I, I, D, I, P],
    "fleet_ew": [I, I, I, L, P, P, P, P, I, P],
    "fleet_tape": [I, I, I, P, P, P, P, P, P, P],
}

#: the base arrays (f64): c_bound [C], sizes, remains, penalties [V]
Base = Sequence[torch.Tensor]
#: one payload row per replica: bw, fs [nb] f64; li [nb, sl] int32,
#: lf [nb, sl] f64, fi [nb, sf] int32, ff [nb, sf] f64, di [nb, sd] int32
Payload = Sequence[torch.Tensor]


def _lib():
    return build.load("fleet_materialize", _SIG)


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _scatter_mul(x: torch.Tensor, idx: torch.Tensor, f: torch.Tensor):
    keep = (idx >= 0) & (idx < x.shape[0])
    i = idx[keep].long()
    x[i] = x[i] * f[keep]


def state_plain(base: Base, payload: Payload, out: Sequence[torch.Tensor],
                b0: int, done_eps: float, done_rel: bool) -> None:
    """Rows ``b0 .. b0+nb-1`` of ``out = (cb, pen, rem, thresh)``."""
    base_cb, base_sz, base_rem, base_pen = base
    bw, fs, li, lf, fi, ff, di = payload
    cb, pen, rem, thresh = out
    for r in range(bw.shape[0]):
        cb64 = base_cb * bw[r]
        _scatter_mul(cb64, li[r], lf[r])
        sz64 = base_sz * fs[r]
        rem64 = base_rem * fs[r]
        _scatter_mul(sz64, fi[r], ff[r])
        _scatter_mul(rem64, fi[r], ff[r])
        pen64 = base_pen.clone()
        keep = (di[r] >= 0) & (di[r] < pen64.shape[0])
        pen64[di[r][keep].long()] = 0.0
        th64 = (done_eps * sz64 if done_rel
                else torch.full_like(sz64, done_eps))
        b = b0 + r
        for dst, src in ((cb, cb64), (pen, pen64), (rem, rem64),
                         (thresh, th64)):
            dst[b].copy_(src.to(dst.dtype))


def ew_plain(base_ew: torch.Tensor, ew: torch.Tensor, ei: torch.Tensor,
             ewv: torch.Tensor, b0: int) -> None:
    """Rows ``b0 .. b0+nb-1`` of the fleet's ``[B, E]`` weights."""
    for r in range(ei.shape[0]):
        row = ew[b0 + r]
        row.copy_(base_ew)
        keep = (ei[r] >= 0) & (ei[r] < row.shape[0])
        row[ei[r][keep].long()] = ewv[r][keep]


def tape_plain(tape: Sequence[torch.Tensor], b: int,
               row: Sequence[torch.Tensor]) -> None:
    for dst, src in zip(tape, row):
        dst[b].copy_(src)


# ---------------------------------------------------------------------------
# wrappers


def _state(base: Base, payload: Payload, out: Sequence[torch.Tensor],
           b0: int, done_eps: float, done_rel: bool) -> bool:
    if on_cpu(*base, *payload, *out):
        state_plain(base, payload, out, b0, done_eps, done_rel)
        return False
    nb = int(payload[0].shape[0])
    C, V = int(base[0].shape[0]), int(base[1].shape[0])
    if any(t.dtype != torch.float64 for t in (*base, payload[0], payload[1],
                                              payload[3], payload[5])):
        raise TypeError("K11's base arrays and factors are float64")
    if any(t.dtype != torch.int32 for t in (payload[2], payload[4],
                                            payload[6])):
        raise TypeError("K11's payload slots are int32")
    if not 0 <= b0 <= int(out[0].shape[0]) - nb:
        raise ValueError(f"rows {b0}..{b0 + nb} outside the fleet")
    dev = base[0].device
    scratch = [torch.empty((nb, n), dtype=torch.float64, device=dev)
               for n in (C, V, V, V)]
    arr = ptr_array([*base, *payload, *scratch, *out])
    rc = _lib().fleet_state(
        is_double(out[0].dtype), nb, int(b0), C, V, arr, 19,
        int(payload[2].shape[1]), int(payload[4].shape[1]),
        int(payload[6].shape[1]), float(done_eps), int(done_rel), stream())
    check(rc, "fleet_state")
    return True


def materialize(base: Base, payload: Payload, out: Sequence[torch.Tensor],
                done_eps: float, done_rel: bool) -> None:
    """Birth: every row of ``out = (cb [B, C], pen, rem, thresh [B, V])``
    from the base arrays and the fleet's payload (``_materialize`` and
    the threshold and dtype casts of ``BatchDrainSim.__init__``)."""
    if _state(base, payload, out, 0, done_eps, done_rel):
        STATE_COUNT.n += 1


def admit_state(base: Base, payload: Payload, out: Sequence[torch.Tensor],
                b: int, done_eps: float, done_rel: bool) -> None:
    """Admission: row ``b`` of ``out`` from a one-row payload
    (``_admit_lane_state``)."""
    if _state(base, payload, out, b, done_eps, done_rel):
        ADMIT_COUNT.n += 1


def _ew(base_ew: torch.Tensor, ew: torch.Tensor, ei: torch.Tensor,
        ewv: torch.Tensor, b0: int) -> bool:
    if on_cpu(base_ew, ew, ei, ewv):
        ew_plain(base_ew, ew, ei, ewv, b0)
        return False
    E = int(base_ew.shape[0])
    if ew.dim() != 2 or int(ew.shape[1]) != E or ew.dtype != base_ew.dtype \
            or ewv.dtype != ew.dtype or ei.dtype != torch.int32:
        raise ValueError("K11's weights: base [E], fleet [B, E] of one "
                         "dtype, int32 slots")
    rc = _lib().fleet_ew(is_double(ew.dtype), int(ei.shape[0]), int(b0), E,
                         ptr(base_ew), ptr(ew), ptr(ei), ptr(ewv),
                         int(ei.shape[1]), stream())
    check(rc, "fleet_ew")
    return True


def materialize_ew(base_ew: torch.Tensor, ew: torch.Tensor,
                   ei: torch.Tensor, ewv: torch.Tensor) -> None:
    """Birth: every row of the fleet's ``[B, E]`` weights
    (``_materialize_ew``)."""
    if _ew(base_ew, ew, ei, ewv, 0):
        EW_COUNT.n += 1


def admit_ew(base_ew: torch.Tensor, ew: torch.Tensor, ei: torch.Tensor,
             ewv: torch.Tensor, b: int) -> None:
    """Admission: row ``b`` of the weights, from a one-row payload
    (``_admit_lane_ew``; clears the previous occupant's row)."""
    if _ew(base_ew, ew, ei, ewv, b):
        ADMIT_EW_COUNT.n += 1


def admit_tape(tape: Sequence[torch.Tensor], b: int,
               row: Sequence[torch.Tensor]) -> None:
    """Admission: row ``b`` of the fleet's tape ``(dates f64 [B, T],
    slots int32, bounds)`` from the admitted row (``_admit_lane_tape``;
    the host resets the replica's cursor)."""
    if on_cpu(*tape, *row):
        return tape_plain(tape, b, row)
    n = int(tape[0].shape[1])
    if any(int(r.shape[0]) != n for r in row):
        raise ValueError(f"the admitted tape row must have {n} entries")
    rc = _lib().fleet_tape(is_double(tape[2].dtype), int(b), n,
                           *(ptr(t) for t in (*tape, *row)), stream())
    check(rc, "fleet_tape")
    ADMIT_TAPE_COUNT.n += 1
