"""K9: the device half of the ELL compaction chain.

Replaces the parts of ``simgrid_tpu/ops/lmm_jax.py``
``_ell_chain_stage`` (``:733-784``) and ``_chain_fetch`` (``:803-815``)
that are not K8's rounds: the per-round live count that ends a stage's
loop, the stable live-first partition of the variable rows
(``_stable_livefirst_perm``, ``:716-731``, whose plain twin is K4's
:func:`~.livefirst_repack.stable_livefirst_perm`), the row gather of the
five variable-row tables and the two carried vectors into the first
``half`` rows, the ``v_final[orig_idx]`` scatter and the fetch
assembly.  The CUDA source is ``csrc/ell_chain.cu``; its partition is
the device scan of ``csrc/scan.cuh`` that K4 runs too.

The chain's rounds are K8's, in one K16 loop a stage: a stage arms the
control words (:func:`chain_arm`: ``LIMIT`` = rounds so far + the
stage's cap, ``HALF`` = the rows the stage keeps, ``VLIVE`` = the live
rows now), and the loop runs rounds while the system is light, the cap
is not spent and more than ``HALF`` variables are live, as
``_ell_chain_stage``'s ``cond`` reads.  No host sync happens inside a
stage.

After the partition the kernel re-derives K8's constraint index over
the kept rows on the device: an entry survives when its row is live and
kept, and since live rows keep their relative order, a stable
compaction of the entry list, renumbered through the partition, lists
every constraint's entries in increasing new position.  Dropped and
dead rows contribute exact identities to every reduction of the round
(they never turn live again), so leaving them out changes no bit.

On CPU tensors the wrappers run the plain PyTorch version and return
True; on CUDA tensors they launch the kernels and return None.
"""

from __future__ import annotations

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

_SIG = {
    "chain_arm": [I, I, I, I, I, I, P, P, P, P, P],
    "chain_stage": [I, I, I, I, I, I, P, I, P],
    "chain_fetch": [I, I, I, I, P, P, P, P, P, P, P, P, P, P],
}

_SCAN_TILE = 2048


class ChainState:
    """The chain's device state between launches: the current variable
    rows (``sys``: the vc tables with K8's constraint index, the
    constraint bounds and FATPIPE flags; ``pen``; ``orig``, each row's
    original slot), the fixpoint state ``w`` (its first ``sys.n_v``
    variable entries are the current rows), the merged values
    ``v_final`` at original numbering, and a second pair of carried
    vectors the partition writes into."""

    def __init__(self, sys: EllSystem, pen: torch.Tensor,
                 orig: torch.Tensor, w: Work):
        self.sys, self.pen, self.orig, self.w = sys, pen, orig, w
        v0 = sys.n_v
        dev, dtype = pen.device, w.v_value.dtype
        self.v0 = v0
        self.v_final = torch.zeros(v0, dtype=dtype, device=dev)
        self.alt_value = torch.zeros(v0, dtype=dtype, device=dev)
        self.alt_fixed = torch.zeros(v0, dtype=torch.bool, device=dev)


# ---------------------------------------------------------------------------
# plain PyTorch versions


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
    c[VLIVE_ACC] = 0
    c[VLIVE] = int((~cs.w.v_fixed[:n] & (cs.pen > 0)).sum())
    c[LIMIT] = MAX_ROUNDS if cap < 0 else int(c[IT]) + cap
    c[HALF] = half
    return True


def _keep_index(sys: EllSystem, keep_row: torch.Tensor,
                new_pos: torch.Tensor, half: int):
    """K8's constraint index over the kept rows (entries of live kept
    rows, renumbered, in their order)."""
    wv = sys.wv
    idx = sys.vcx_idx.long()
    rows = idx // wv
    sel = keep_row[rows]
    nidx = (new_pos[rows] * wv + idx % wv)[sel].to(torch.int32)
    ptr_ = sys.vcx_ptr.long()
    seg = torch.repeat_interleave(torch.arange(sys.n_c, device=idx.device),
                                  ptr_[1:] - ptr_[:-1])
    counts = torch.bincount(seg[sel], minlength=sys.n_c)
    nptr = torch.zeros(sys.n_c + 1, dtype=torch.int64, device=idx.device)
    nptr[1:] = torch.cumsum(counts, 0)
    return nptr.to(torch.int32), nidx


def chain_stage_plain(cs: ChainState, half: int) -> bool:
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
    vptr, vidx = _keep_index(sys, keep_row, new_pos, half)
    cs.alt_value[:half].copy_(vv[keep])
    cs.alt_fixed[:half].copy_(vf[keep])
    w.v_value, cs.alt_value = cs.alt_value, w.v_value
    w.v_fixed, cs.alt_fixed = cs.alt_fixed, w.v_fixed
    cs.sys = sys._replace(vc_cnst=sys.vc_cnst[keep], vc_w=sys.vc_w[keep],
                          vc_valid=sys.vc_valid[keep], vcx_ptr=vptr,
                          vcx_idx=vidx)
    cs.pen = cs.pen[keep]
    cs.orig = cs.orig[keep]
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
    """Arm a stage (``cap`` rounds at most while more than ``half``
    variables are live) or, with ``cap < 0`` and ``half = -1``, the
    finisher (rounds to ``MAX_ROUNDS``); ``first`` also arms a fresh
    fixpoint from the carried init (round 0, light count, overflow
    cleared)."""
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


def chain_stage(cs: ChainState, half: int):
    """End a stage: record the rows' values in ``v_final``, flag an
    overflow (more than ``half`` live rows left with light constraints),
    and keep the first ``half`` rows of the stable live-first partition
    (tables, penalties, original slots, values, fixed flags), with K8's
    constraint index re-derived over them."""
    w, sys = cs.w, cs.sys
    if on_cpu(cs.pen, w.ctrl):
        return chain_stage_plain(cs, half)
    lib = build.load("ell_chain", _SIG)
    dev = cs.pen.device
    n, wv, nc = sys.n_v, sys.wv, sys.n_c
    nnz = int(sys.vcx_idx.shape[0])

    def empty(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)
    vc_cnst2 = empty((half, wv), torch.int32)
    vc_w2 = empty((half, wv), sys.vc_w.dtype)
    vc_valid2 = empty((half, wv), torch.bool)
    pen2 = empty(half, cs.pen.dtype)
    orig2 = empty(half, torch.int32)
    vptr2 = empty(nc + 1, torch.int32)
    vidx2 = empty(max(nnz, 1), torch.int32)
    n_blk = -(-max(n, nnz) // _SCAN_TILE) + 1
    flags = (n + nnz + 15) & ~15
    scratch = empty(flags + 4 * (3 * n + nnz + n_blk + 4), torch.uint8)
    ptrs = ptr_array([
        sys.vc_cnst, sys.vc_w, sys.vc_valid, cs.pen, cs.orig, w.v_value,
        w.v_fixed, sys.vcx_ptr, sys.vcx_idx, vc_cnst2, vc_w2, vc_valid2,
        pen2, orig2, cs.alt_value, cs.alt_fixed, vptr2, vidx2, cs.v_final,
        w.ctrl, scratch])
    rc = lib.chain_stage(is_double(cs.pen.dtype), n, wv, nc, int(half),
                         nnz, ptrs, 21, stream())
    check(rc, "chain_stage")
    STAGE_COUNT.n += 1
    w.v_value, cs.alt_value = cs.alt_value, w.v_value
    w.v_fixed, cs.alt_fixed = cs.alt_fixed, w.v_fixed
    cs.sys = sys._replace(vc_cnst=vc_cnst2, vc_w=vc_w2, vc_valid=vc_valid2,
                          vcx_ptr=vptr2, vcx_idx=vidx2)
    cs.pen = pen2
    cs.orig = orig2
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
