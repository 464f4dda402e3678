"""K9: the device half of the ELL compaction chain.

Replaces the parts of ``simgrid_tpu/ops/lmm_jax.py``
``_ell_chain_stage`` (``:733-784``) and ``_chain_fetch`` (``:803-815``)
that are not K8's rounds: the arming of the stage's round loop, the
stable live-first partition of the variable rows
(``_stable_livefirst_perm``, ``:716-731``, whose plain twin is K4's
:func:`~.livefirst_repack.stable_livefirst_perm`), the row gather of the
five variable-row tables and the two carried vectors into the first
``half`` rows, the ``v_final[orig_idx]`` scatter and the fetch
assembly.  The CUDA source is ``csrc/ell_chain.cu``.

The chain's rounds are K8's, in one K16 loop a stage: the control
words say how far a stage's loop runs (``LIMIT`` = rounds so far + the
stage's cap, ``HALF`` = the rows the stage keeps, ``VLIVE`` = the live
rows), and the loop runs rounds while the system is light, the cap is
not spent and more than ``HALF`` variables are live, as
``_ell_chain_stage``'s ``cond`` reads.  :func:`chain_arm` arms the
first loop (and, with ``first``, starts the fixpoint); a stage arms the
next one itself (:func:`chain_stage`'s ``arm``).

A stage also re-derives K8's entry layout over the kept rows: an entry
survives when its row is live and kept, and since live rows keep their
relative order, a stable compaction of the entry list, renumbered
through the partition, lists every constraint's entries in increasing
new position; the entries carry their weights and ``w / penalty``.
Dropped and dead rows contribute exact identities to every reduction
of the round (they never turn live again), so leaving them out changes
no bit.

A :class:`ChainState` owns every buffer a chain of its shape writes:
the next stages' tables and layouts are fixed slices of a ping-pong
pair (stage ``s`` writes pair ``s % 2``), the carried vectors another
pair, and the scan's scratch; nothing is allocated between stages, so
the whole chain can be one K16 graph.

On CPU tensors the wrappers run the plain PyTorch version and return
True; on CUDA tensors they launch the kernels and return None.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build
from .common import (ARMED, HALF, IT, LIGHT, LIGHT_ACC, LIMIT, MAX_ROUNDS,
                     OVERFLOW, VLIVE, VLIVE_ACC, EllSystem, I, P, Work,
                     check, counter, is_double, on_cpu, ptr, ptr_array,
                     stream)
from .livefirst_repack import stable_livefirst_perm

ARM_COUNT = counter("ell_chain_arm")
STAGE_COUNT = counter("ell_chain_stage")
FETCH_COUNT = counter("ell_chain_fetch")

#: buffers handed to chain_stage as one pointer array, in this order
N_STAGE_PTRS = 29
#: rows and entries a tile of the stage's scans covers (csrc/ell_chain.cu)
ROW_TILE = 256
ENT_TILE = 512

_SIG = {
    "chain_arm": [I, I, I, I, I, I, P, P, P, P, P],
    "chain_stage": [I, I, I, I, I, I, I, I, I, I, P, I, P],
    "chain_fetch": [I, I, I, I, P, P, P, P, P, P, P, P, P, P],
}

#: the next stage's tables and entry layout, in EllSystem's names
_TABLES = ("vc_cnst", "vc_w", "vc_valid")
_LAYOUT = ("vcx_ptr", "vcx_idx", "vcx_row", "vcx_w", "vcx_upen")


def _tiles(n: int, tile: int) -> int:
    return max(1, -(-n // tile))


class ChainState:
    """The chain's device state between launches: the current variable
    rows (``sys``: the vc tables with K8's entry layout, the constraint
    bounds and FATPIPE flags; ``pen``; ``orig``, each row's original
    slot), the fixpoint state ``w`` (its first ``sys.n_v`` variable
    entries are the current rows), the merged values ``v_final`` at
    original numbering, and every buffer the stages write: two sets of
    next-stage tables and layouts of ``V0 // 2`` rows and the first
    layout's capacity, a second pair of carried vectors, and the
    partition's scratch.  ``stage`` counts the stages done since
    :meth:`reset`."""

    def __init__(self, sys: EllSystem, pen: torch.Tensor,
                 orig: torch.Tensor, w: Work):
        v0, nc, wv = sys.n_v, sys.n_c, sys.wv
        dev, dtype = pen.device, w.v_value.dtype
        nnz = int(sys.vcx_row.shape[0])
        h = max(v0 // 2, 1)

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)
        self.v0, self.nnz, self.w = v0, nnz, w
        self.v_final = z(v0, dtype)
        self.pairs = ((w.v_value, w.v_fixed),
                      (z(v0, dtype), z(v0, torch.bool)))
        self.bufs = tuple(dict(
            vc_cnst=z((h, wv), torch.int32), vc_w=z((h, wv), dtype),
            vc_valid=z((h, wv), torch.bool), pen=z(h, pen.dtype),
            orig=z(h, torch.int32), vcx_ptr=z(nc + 1, torch.int32),
            vcx_idx=z(nnz, torch.int32), vcx_row=z(nnz, torch.int32),
            vcx_w=z(nnz, dtype), vcx_upen=z(nnz, dtype)) for _ in range(2))
        #: row positions, the scans' status words and start counters
        #: (sized for the first stage), the live count
        self.tiles_v = _tiles(v0, ROW_TILE)
        self.rpos = z(v0, torch.int32)
        self.status = z(self.tiles_v + _tiles(nnz, ENT_TILE) + 2,
                        torch.int64)
        self.totals = z(4, torch.int32)
        self.reset(sys, pen, orig)

    def reset(self, sys: EllSystem, pen: torch.Tensor,
              orig: torch.Tensor) -> None:
        """Back to the first stage over ``sys``, ``pen`` and ``orig`` (the
        upload's; the same shape), the carried vectors in ``w``'s own
        pair."""
        self.first = (sys, pen, orig)
        self.goto(())

    def goto(self, halves: Sequence[int]) -> None:
        """The state after the stages that kept ``halves`` rows, in order
        (the stages' buffers are fixed, so this only points at them)."""
        sys, pen, orig = self.first
        self.stage = len(halves)
        self.w.v_value, self.w.v_fixed = self.pairs[self.stage % 2]
        if halves:
            n = halves[-1]
            b = self.bufs[(self.stage - 1) % 2]
            sys = sys._replace(**{k: b[k][:n] for k in _TABLES},
                               **{k: b[k] for k in _LAYOUT})
            pen, orig = b["pen"][:n], b["orig"][:n]
        self.sys, self.pen, self.orig = sys, pen, orig
        self.halves = tuple(halves)

    def _out(self):
        """The next stage's tables, layout and carried vectors."""
        b = self.bufs[self.stage % 2]
        val, fix = self.pairs[(self.stage + 1) % 2]
        return b, val, fix


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _arm_words(c, cap: int, half: int, vlive: int) -> None:
    c[VLIVE_ACC] = 0
    c[VLIVE] = vlive
    c[LIMIT] = MAX_ROUNDS if cap < 0 else int(c[IT]) + cap
    c[HALF] = half


def chain_arm_plain(cs: ChainState, cap: int, half: int,
                    first: bool) -> bool:
    c = cs.w.ctrl
    n = cs.sys.n_v
    if first:
        c[IT] = 0
        c[ARMED] = 1
        c[LIGHT_ACC] = 0
        c[OVERFLOW] = 0
        c[LIGHT] = int(cs.w.light.sum())
    _arm_words(c, cap, half, int((~cs.w.v_fixed[:n] & (cs.pen > 0)).sum()))
    return True


def _keep_layout(sys: EllSystem, keep_row: torch.Tensor,
                 new_pos: torch.Tensor):
    """K8's entry layout over the kept rows (entries of live kept rows,
    renumbered, in their order): ptr, idx, row, w, upen."""
    wv = sys.wv
    n = int(sys.vcx_ptr[-1])
    idx = sys.vcx_idx[:n].long()
    rows = sys.vcx_row[:n].long()
    sel = keep_row[rows]
    nrow = new_pos[rows][sel]
    nidx = nrow * wv + (idx - rows * wv)[sel]
    ptr_ = sys.vcx_ptr.long()
    seg = torch.repeat_interleave(torch.arange(sys.n_c, device=idx.device),
                                  ptr_[1:] - ptr_[:-1])
    counts = torch.bincount(seg[sel], minlength=sys.n_c)
    nptr = torch.zeros(sys.n_c + 1, dtype=torch.int64, device=idx.device)
    nptr[1:] = torch.cumsum(counts, 0)
    return (nptr, nidx, nrow, sys.vcx_w[:n][sel], sys.vcx_upen[:n][sel])


def chain_stage_plain(cs: ChainState, half: int,
                      arm: Optional[Tuple[int, int]] = None) -> bool:
    sys, w = cs.sys, cs.w
    n = sys.n_v
    vv, vf = w.v_value[:n], w.v_fixed[:n]
    cs.v_final[cs.orig.long()] = vv
    livemask = ~vf & (cs.pen > 0)
    n_live = int(livemask.sum())
    if n_live > half and int(w.ctrl[LIGHT]) > 0:
        w.ctrl[OVERFLOW] = 1
    perm = stable_livefirst_perm(livemask)
    keep = perm[:half]
    new_pos = torch.empty(n, dtype=torch.int64, device=vv.device) \
        .scatter_(0, perm, torch.arange(n, device=vv.device))
    keep_row = livemask & (new_pos < half)
    layout = _keep_layout(sys, keep_row, new_pos)
    b, val, fix = cs._out()
    for k in _TABLES:
        b[k][:half] = getattr(sys, k)[keep]
    b["pen"][:half] = cs.pen[keep]
    b["orig"][:half] = cs.orig[keep]
    for k, x in zip(_LAYOUT, layout):
        b[k][:len(x)] = x
    val[:half] = vv[keep]
    fix[:half] = vf[keep]
    if arm is not None:
        _arm_words(w.ctrl, arm[0], arm[1], min(n_live, half))
    cs.goto(cs.halves + (half,))
    return True


def chain_fetch_plain(cs: ChainState, out: torch.Tensor) -> bool:
    w = cs.w
    n = cs.sys.n_v
    cs.v_final[cs.orig.long()] = w.v_value[:n]
    v0, nc = cs.v0, cs.sys.n_c
    out[0] = int(w.ctrl[IT])
    out[1] = int(w.light.sum())
    out[2] = int(w.v_fixed[:n].sum())
    out[3] = int(w.ctrl[OVERFLOW])
    out[4:4 + v0] = cs.v_final
    out[4 + v0:4 + v0 + nc] = w.remaining
    out[4 + v0 + nc:4 + v0 + 2 * nc] = w.usage
    return True


# ---------------------------------------------------------------------------
# wrappers


def chain_arm(cs: ChainState, cap: int, half: int, first: bool = False):
    """Arm a stage's loop (``cap`` rounds at most while more than
    ``half`` variables are live) or, with ``cap < 0`` and ``half = -1``,
    the finisher's (rounds to ``MAX_ROUNDS``); ``first`` also arms a
    fresh fixpoint from the carried init (round 0, light count,
    overflow cleared).  One launch."""
    w = cs.w
    if on_cpu(cs.pen, w.ctrl):
        return chain_arm_plain(cs, cap, half, first)
    lib = build.load("ell_chain", _SIG)
    rc = lib.chain_arm(is_double(cs.pen.dtype), cs.sys.n_v, cs.sys.n_c,
                       int(cap), int(half), int(first), ptr(cs.pen),
                       ptr(w.v_fixed), ptr(w.light), ptr(w.ctrl), stream())
    check(rc, "chain_arm")
    ARM_COUNT.n += 1
    return None


def chain_stage(cs: ChainState, half: int,
                arm: Optional[Tuple[int, int]] = None):
    """End a stage: record the rows' values in ``v_final``, flag an
    overflow (more than ``half`` live rows left with light constraints),
    and keep the first ``half`` rows of the stable live-first partition
    (tables, penalties, original slots, values, fixed flags) with K8's
    entry layout re-derived over them, in the state's next buffers;
    ``arm = (cap, next_half)`` also arms the next round loop as
    :func:`chain_arm` would.  Two launches, no allocation."""
    w, sys = cs.w, cs.sys
    if on_cpu(cs.pen, w.ctrl):
        return chain_stage_plain(cs, half, arm)
    lib = build.load("ell_chain", _SIG)
    b, val, fix = cs._out()
    ptrs = ptr_array([
        sys.vc_cnst, sys.vc_w, sys.vc_valid, cs.pen, cs.orig, w.v_value,
        w.v_fixed, sys.vcx_ptr, sys.vcx_idx, sys.vcx_row, sys.vcx_w,
        sys.vcx_upen, b["vc_cnst"], b["vc_w"], b["vc_valid"], b["pen"],
        b["orig"], val, fix, b["vcx_ptr"], b["vcx_idx"], b["vcx_row"],
        b["vcx_w"], b["vcx_upen"], cs.v_final, w.ctrl, cs.rpos, cs.status,
        cs.totals])
    cap, nxt = arm if arm is not None else (0, 0)
    rc = lib.chain_stage(is_double(cs.pen.dtype), sys.n_v, sys.wv,
                         sys.n_c, int(half), cs.nnz, int(arm is not None),
                         int(cap), int(nxt), cs.tiles_v, ptrs,
                         N_STAGE_PTRS, stream())
    check(rc, "chain_stage")
    STAGE_COUNT.n += 1
    cs.goto(cs.halves + (half,))
    return None


def chain_fetch(cs: ChainState, out: torch.Tensor):
    """Merge the current rows' values into ``v_final`` and assemble the
    one transfer of a finisher chunk into ``out`` (dtype, length
    ``4 + V0 + 2 C``): rounds, light count, fixed count, overflow flag,
    then the merged values, remaining and usage."""
    w = cs.w
    if on_cpu(cs.pen, w.ctrl, out):
        return chain_fetch_plain(cs, out)
    lib = build.load("ell_chain", _SIG)
    rc = lib.chain_fetch(is_double(cs.pen.dtype), cs.sys.n_v, cs.v0,
                         cs.sys.n_c, ptr(cs.orig), ptr(w.v_value),
                         ptr(w.v_fixed), ptr(w.light), ptr(w.remaining),
                         ptr(w.usage), ptr(cs.v_final), ptr(w.ctrl),
                         ptr(out), stream())
    check(rc, "chain_fetch")
    FETCH_COUNT.n += 1
    return None
