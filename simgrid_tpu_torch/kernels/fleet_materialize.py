"""K11: a fleet's per-replica state, materialised on the card.

Replaces ``simgrid_tpu/ops/lmm_batch.py`` ``_materialize``
(``:390-407``) and ``_materialize_ew`` (``:375-388``) at the fleet's
birth, with a collective fleet's birth rows (``:1083-1089``, B copies of
the schedule's predecessor counts and activation dates, the Kahan pairs
at zero), and ``_admit_lane_state`` (``:409-437``), ``_admit_lane_tape``
(``:440-449``), ``_admit_lane_coll`` (``:453-461``) and
``_admit_lane_ew`` (``:463-470``) when one replica is admitted into row
``b`` of a live fleet.  The CUDA source is ``csrc/fleet_materialize.cu``:
a birth (:func:`materialize`) is one launch, an admission (:func:`admit`)
one launch, whatever parts the fleet has.

The arithmetic is ``derive_replica_arrays``'s, in its order and in f64:
``base * scale`` first, then the sparse factors; dead flows get penalty
0; thresholds are ``done_eps * size`` (``done_mode`` "rel") or
``done_eps``; then the cast to the fleet's dtype.  Weights are the
shared table with the payload's weights SET at their slots.

The payload is host arrays: the rows of ``ops/lmm_batch._pack_overrides``
and ``_pack_elem_w`` (index arrays padded with an out-of-range slot,
which drops; factors padded with 1.0) and, at an admission, the tape
entries (padded to the fleet's tape width by the entry itself).  Every slot row must be strictly increasing with its pads (slots
>= the axis length) last, as the packers write them: the kernel finds
"is slot i overridden" by binary search.  Both routes refuse any other
row (``ValueError``) before anything is written.  On the card the
arrays are packed into one pinned buffer (:func:`layout`, :func:`pack`;
the parts ``common.FP_*``, twinned in ``csrc/fleet_payload.cuh``), which
the C entry uploads in one copy ahead of its launch.

On CPU tensors each entry runs its fused plain version
(:func:`materialize_plain`, :func:`admit_plain`: the per-part plain
versions in JAX's order); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .common import (D, FP_ALIGN, FP_EI, FP_EWV, FP_PARTS, FP_TS, FP_TT,
                     FP_TV, I, L, P, Staging, check, counter, is_double,
                     on_cpu, ptr_array, stream)

#: birth launches, without and with a collective fleet's rows
BIRTH_COUNT = counter("fleet_materialize")
BIRTH_COLL_COUNT = counter("fleet_materialize_coll")
#: admission launches, without and with a collective fleet's rows
ADMIT_COUNT = counter("fleet_admit")
ADMIT_COLL_COUNT = counter("fleet_admit_coll")

_SIG = {"fleet_materialize": [I, I, I, I, I, L, I, I, I, I, I, I, I, I, D,
                              P, I, P, I, P, P, L, P]}

#: pointers in the C entry's array (keep in sync with the source)
N_FM_PTRS = 18

#: the base arrays (f64): c_bound [C], sizes, remains, penalties [V]
Base = Sequence[torch.Tensor]
#: one payload row per replica (numpy): bw, fs [nb] f64; li [nb, sl]
#: int32, lf [nb, sl] f64, fi [nb, sf] int32, ff [nb, sf] f64, di [nb,
#: sd] int32
Payload = Sequence[np.ndarray]
#: per-replica weights: (the shared table [E], the fleet's [B, E], ei
#: [nb, se] int32 and ewv [nb, se] in the fleet's dtype, numpy)
Weights = Tuple[torch.Tensor, torch.Tensor, np.ndarray, np.ndarray]
#: an admission's tape: ((dates f64, slots int32, bounds) [B, T], the
#: admitted entries (dates f64, slots int32, bounds in the fleet's
#: dtype) [n <= T], numpy; the row is padded to T with (inf, C, 0))
Tape = Tuple[Sequence[torch.Tensor], Sequence[np.ndarray]]
#: a collective fleet's rows: ((pred [B, V] int32, ready [B, V] f64,
#: clk [B, 2] f64), the schedule's birth rows (pred0, ready0) [V])
Coll = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]

_NP = {torch.float64: np.float64, torch.float32: np.float32}
_STAGE = Staging("K11's payload")


def _lib():
    return build.load("fleet_materialize", _SIG)


# ---------------------------------------------------------------------------
# the payload on the host


def check_slots(idx: np.ndarray, n: int, what: str) -> None:
    """Refuse payload slot rows ``[nb, s]`` (int32) that are not strictly
    increasing with their pads (slots >= ``n``, dropped) last."""
    if not isinstance(idx, np.ndarray) or idx.ndim != 2 \
            or idx.dtype != np.int32:
        raise TypeError(f"K11's {what} are an int32 numpy array "
                        "[rows, width]")
    if idx.size and idx.min() < 0:
        raise ValueError(f"K11's {what} hold a negative slot")
    if idx.shape[1] > 1:
        # pads clipped to n: each entry above the one before, or a pad
        c = np.minimum(idx, n)
        if not ((c[:, 1:] > c[:, :-1]) | (c[:, 1:] == n)).all():
            raise ValueError(f"K11's {what} must be strictly increasing "
                             f"in every row, with their pads (>= {n}) "
                             "last")


def _f64(a, shape, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype != np.float64 or a.shape != shape:
        raise TypeError(f"K11's {what} are float64 {list(shape)}")
    return a


def _parts(base: Base, payload: Payload, out: Sequence[torch.Tensor],
           b0: int, ew: Optional[Weights], tape: Optional[Tape],
           coll: Optional[Coll]) -> List[Optional[np.ndarray]]:
    """The call's payload parts in ``FP_*`` order (None: absent), each
    checked."""
    if len(payload) != 7:
        raise ValueError("K11's payload is (bw, fs, li, lf, fi, ff, di)")
    C, V = int(base[0].shape[0]), int(base[1].shape[0])
    B = int(out[0].shape[0])
    li, fi, di = (np.ascontiguousarray(payload[k]) for k in (2, 4, 6))
    nb = int(np.shape(payload[0])[0])
    bw, fs = (_f64(payload[k], (nb,), "scales") for k in (0, 1))
    for idx, n, what in ((li, C, "link slots"), (fi, V, "flow slots"),
                         (di, V, "dead flows")):
        check_slots(idx, n, what)
        if idx.shape[0] != nb:
            raise ValueError(f"K11's {what} must have {nb} rows")
    lf = _f64(payload[3], li.shape, "link factors")
    ff = _f64(payload[5], fi.shape, "flow factors")
    if nb < 1 or not 0 <= b0 <= B - nb:
        raise ValueError(f"rows {b0}..{b0 + nb} outside the fleet")
    parts = [bw, fs, li, lf, fi, ff, di] + [None] * (FP_PARTS - 7)
    dt = _NP.get(out[0].dtype)
    if dt is None:
        raise TypeError(f"K11 writes float32 or float64, not "
                        f"{out[0].dtype}")
    if ew is not None:
        ei = np.ascontiguousarray(ew[2])
        check_slots(ei, int(ew[0].shape[0]), "element slots")
        ewv = np.ascontiguousarray(ew[3])
        if ei.shape[0] != nb or ewv.shape != ei.shape or ewv.dtype != dt:
            raise TypeError(f"K11's element weights are {np.dtype(dt)} "
                            f"[{nb}, width], as their slots")
        parts[FP_EI], parts[FP_EWV] = ei, ewv
    if tape is not None:
        T = int(tape[0][0].shape[1])
        row_t, row_s, row_v = (np.ascontiguousarray(a) for a in tape[1])
        n = len(row_t)
        if nb != 1 or n > T or row_t.shape != (n,) \
                or row_t.dtype != np.float64 or row_s.shape != (n,) \
                or row_s.dtype != np.int32 or row_v.shape != (n,) \
                or row_v.dtype != dt:
            raise ValueError(f"the admitted tape is one row of at most {T} "
                             f"entries (f64 dates, int32 slots, "
                             f"{np.dtype(dt)} bounds)")
        parts[FP_TT], parts[FP_TS], parts[FP_TV] = row_t, row_s, row_v
    if coll is not None:
        (pred, ready, clk), row = coll
        if pred.dtype != torch.int32 or row[0].dtype != torch.int32 \
                or any(t.dtype != torch.float64
                       for t in (ready, clk, row[1])) \
                or tuple(pred.shape) != (B, V) \
                or tuple(ready.shape) != (B, V) \
                or tuple(clk.shape) != (B, 2) \
                or any(tuple(r.shape) != (V,) for r in row):
            raise ValueError("K11's collective rows: pred [B, V] int32, "
                             "ready [B, V] and clk [B, 2] float64, birth "
                             "rows [V]")
    return parts


def layout(parts: Sequence[Optional[np.ndarray]]) -> Tuple[List[int], int]:
    """Each part's byte offset in the packed buffer (a multiple of
    ``FP_ALIGN``; an absent part takes no room) and the buffer's size."""
    off, n = [], 0
    for a in parts:
        off.append(n)
        if a is not None:
            n += -(-a.nbytes // FP_ALIGN) * FP_ALIGN
    return off, n


def pack(parts: Sequence[Optional[np.ndarray]], buf: np.ndarray,
         off: Sequence[int]) -> None:
    """Write every part into the byte buffer ``buf`` at its offset (the
    gaps zero), in one copy."""
    chunks, end = [], 0
    for a, o in zip(parts, off):
        if a is not None and a.nbytes:
            chunks += [bytes(o - end), a.tobytes()]
            end = o + a.nbytes
    buf[:end] = np.frombuffer(b"".join(chunks), np.uint8)


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _scatter_mul(x: torch.Tensor, idx: torch.Tensor, f: torch.Tensor):
    keep = (idx >= 0) & (idx < x.shape[0])
    i = idx[keep].long()
    x[i] = x[i] * f[keep]


def state_plain(base: Base, payload: Sequence[torch.Tensor],
                out: Sequence[torch.Tensor], b0: int, done_eps: float,
                done_rel: bool) -> None:
    """Rows ``b0 .. b0+nb-1`` of ``out = (cb, pen, rem, thresh)``
    (payload tensors)."""
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
               row: Sequence[torch.Tensor], pad_slot: int) -> None:
    """Row ``b`` of the fleet's tape: the admitted entries ``row``,
    padded with (inf, ``pad_slot``, 0)."""
    n = row[0].shape[0]
    for dst, src, pad in zip(tape, row, (float("inf"), pad_slot, 0)):
        dst[b, n:].fill_(pad)
        dst[b, :n].copy_(src)


def coll_plain(coll: Sequence[torch.Tensor], b0: int, nb: int,
               row: Sequence[torch.Tensor]) -> None:
    """Rows ``b0 .. b0+nb-1`` of a collective fleet's ``(pred, ready,
    clk)``: the schedule's birth rows, the clock pairs at zero."""
    pred, ready, clk = coll
    for b in range(b0, b0 + nb):
        pred[b].copy_(row[0])
        ready[b].copy_(row[1])
        clk[b].zero_()


def _plain(base: Base, payload: Payload, out: Sequence[torch.Tensor],
           b0: int, done_eps: float, done_rel: bool, ew: Optional[Weights],
           tape: Optional[Tape], coll: Optional[Coll], birth: bool) -> None:
    dev = out[0].device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nb = int(np.shape(payload[0])[0])
    if birth and ew is not None:
        ew_plain(ew[0], ew[1], put(ew[2]), put(ew[3]), b0)
    state_plain(base, [put(a) for a in payload], out, b0, done_eps,
                done_rel)
    if tape is not None:
        tape_plain(tape[0], b0, [put(a) for a in tape[1]],
                   int(base[0].shape[0]))
    if coll is not None:
        coll_plain(coll[0], b0, nb, coll[1])
    if not birth and ew is not None:
        ew_plain(ew[0], ew[1], put(ew[2]), put(ew[3]), b0)


def materialize_plain(base: Base, payload: Payload,
                      out: Sequence[torch.Tensor], done_eps: float,
                      done_rel: bool, ew: Optional[Weights] = None,
                      coll: Optional[Coll] = None) -> None:
    """The plain birth on the tensors' device, in JAX's order: the
    weights (``_materialize_ew``), the state (``_materialize``, the
    thresholds and the casts), the collective rows."""
    _plain(base, payload, out, 0, done_eps, done_rel, ew, None, coll, True)


def admit_plain(base: Base, payload: Payload, out: Sequence[torch.Tensor],
                b: int, done_eps: float, done_rel: bool,
                ew: Optional[Weights] = None, tape: Optional[Tape] = None,
                coll: Optional[Coll] = None) -> None:
    """The plain admission of row ``b``, in JAX's order: the state
    (``_admit_lane_state``), the tape row, the collective rows, the
    weights (``_admit_lane_ew``)."""
    _plain(base, payload, out, b, done_eps, done_rel, ew, tape, coll,
           False)


# ---------------------------------------------------------------------------
# the wrappers


def _call(base: Base, payload: Payload, out: Sequence[torch.Tensor],
          b0: int, done_eps: float, done_rel: bool, ew: Optional[Weights],
          tape: Optional[Tape], coll: Optional[Coll], birth: bool) -> bool:
    parts = _parts(base, payload, out, b0, ew, tape, coll)
    tensors = [*base, *out]
    if ew is not None:
        tensors += ew[:2]
    if tape is not None:
        tensors += list(tape[0])
    if coll is not None:
        tensors += [*coll[0], *coll[1]]
    if on_cpu(*tensors):
        _plain(base, payload, out, b0, done_eps, done_rel, ew, tape, coll,
               birth)
        return False
    if any(t.dtype != torch.float64 for t in base):
        raise TypeError("K11's base arrays are float64")
    dt = out[0].dtype
    if any(t.dtype != dt for t in out) or (
            ew is not None and (ew[0].dtype != dt or ew[1].dtype != dt
                                or ew[1].dim() != 2
                                or ew[1].shape[1] != ew[0].shape[0])) or (
            tape is not None and tape[0][2].dtype != dt):
        raise ValueError("K11's outputs, weights and tape bounds are of "
                         "the fleet's one dtype, its weights [B, E]")
    dev = out[0].device
    off, n = layout(parts)
    host, host_t, dev_t, capturing = _STAGE.take(dev, n)
    pack(parts, host, off)
    base_ew, ew_t = (None, None) if ew is None else ew[:2]
    tape_t = (None,) * 3 if tape is None else tuple(tape[0])
    coll_t, coll_row = ((None,) * 3, (None,) * 2) if coll is None else (
        tuple(coll[0]), tuple(coll[1]))
    ptrs = ptr_array([*base, *out, base_ew, ew_t, *tape_t, *coll_row,
                      *coll_t])
    width = [int(parts[k].shape[1]) for k in (2, 4, 6)]
    width.append(0 if ew is None else int(parts[FP_EI].shape[1]))
    try:
        rc = _lib().fleet_materialize(
            is_double(dt), int(parts[0].shape[0]), int(b0),
            int(base[0].shape[0]), int(base[1].shape[0]),
            0 if ew is None else int(ew[0].shape[0]),
            0 if tape is None else int(tape[0][0].shape[1]),
            0 if tape is None else len(parts[FP_TT]),
            int(coll is not None), *width, int(done_rel), float(done_eps),
            ptrs, N_FM_PTRS, (ctypes.c_longlong * FP_PARTS)(*off),
            FP_PARTS, ctypes.c_void_p(host_t.data_ptr()),
            ctypes.c_void_p(dev_t.data_ptr()), n, stream())
    finally:
        _STAGE.launched(dev, capturing)
    check(rc, "fleet_materialize")
    return True


def materialize(base: Base, payload: Payload, out: Sequence[torch.Tensor],
                done_eps: float, done_rel: bool,
                ew: Optional[Weights] = None,
                coll: Optional[Coll] = None) -> None:
    """Birth: every row of ``out = (cb [B, C], pen, rem, thresh [B, V])``
    from the base arrays and the fleet's payload (``_materialize`` and
    the threshold and dtype casts of ``BatchDrainSim.__init__``), with
    the weights (``ew``) and a collective fleet's rows (``coll``) where
    given: one launch."""
    if _call(base, payload, out, 0, done_eps, done_rel, ew, None, coll,
             True):
        (BIRTH_COUNT if coll is None else BIRTH_COLL_COUNT).n += 1


def admit(base: Base, payload: Payload, out: Sequence[torch.Tensor], b: int,
          done_eps: float, done_rel: bool, ew: Optional[Weights] = None,
          tape: Optional[Tape] = None, coll: Optional[Coll] = None) -> None:
    """Admission: row ``b`` of ``out`` from a one-row payload
    (``_admit_lane_state``), with its tape row (``_admit_lane_tape``: the
    admitted entries, padded on the device; the host resets the
    replica's cursor), its collective rows
    (``_admit_lane_coll``) and its weight row (``_admit_lane_ew``, which
    clears the previous occupant's) where given: one launch."""
    if _call(base, payload, out, int(b), done_eps, done_rel, ew, tape,
             coll, False):
        (ADMIT_COUNT if coll is None else ADMIT_COLL_COUNT).n += 1
