"""K4: the drain's on-device repack to halved shapes.

Replaces ``simgrid_tpu/ops/lmm_jax.py`` ``_stable_livefirst_perm``
(``:716-731``) and ``simgrid_tpu/ops/lmm_drain.py`` ``_drain_repack``
(``:606-644``) with ``_repack_vbound`` (``:647-651``: the rate bounds
follow the flow rows' permutation when the drain has bounds); the CUDA
source is ``csrc/livefirst_repack.cu``.  It also re-derives both row
indexes of the halved system.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.csr import Csr, build_csr
from . import build
from .common import (I, LmmSystem, P, check, counter, is_double, on_cpu,
                     opt_ptr, ptr, stream)

COUNT = counter("livefirst_repack")
#: launches that carried the rate bounds along
VBOUND_COUNT = counter("livefirst_repack_vbound")

_SIG = {"livefirst_repack": [I] * 8 + [P] * 26}

_SCAN_TILE = 2048


class Repacked(NamedTuple):
    sys: LmmSystem
    pen: torch.Tensor
    rem: torch.Tensor
    thresh: torch.Tensor
    ids: torch.Tensor
    vb: Optional[torch.Tensor] = None


def stable_livefirst_perm(livemask: torch.Tensor) -> torch.Tensor:
    """perm[k] = index of the k-th row when live rows come first, each
    side keeping its original relative order."""
    lm = livemask.to(torch.int64)
    n_live = lm.sum()
    pos = torch.where(livemask, torch.cumsum(lm, 0) - 1,
                      n_live + torch.cumsum(1 - lm, 0) - 1)
    n = livemask.shape[0]
    return torch.empty(n, dtype=torch.int64, device=livemask.device) \
        .scatter_(0, pos, torch.arange(n, device=livemask.device))


def livefirst_repack_plain(sys: LmmSystem, pen, rem, thresh, ids,
                           vh: int, eh: int, live_elems: int,
                           vb=None) -> Repacked:
    V = pen.shape[0]
    livemask = pen > 0
    perm_v = stable_livefirst_perm(livemask)
    keep_v = perm_v[:vh]
    old2new = torch.empty(V, dtype=torch.int64, device=pen.device) \
        .scatter_(0, perm_v, torch.arange(V, device=pen.device))
    ev = sys.e_var.long()
    elive = (sys.e_w > 0) & livemask[ev]
    sel = stable_livefirst_perm(elive)[:eh]
    ev2 = torch.clamp(old2new[ev[sel]], max=vh - 1).to(torch.int32)
    ec2 = sys.e_cnst[sel]
    ew2 = torch.where(elive[sel], sys.e_w[sel], 0.0)
    csr = build_csr(ev2, ec2, ew2, sys.n_c, vh)
    return Repacked(LmmSystem(ev2, ec2, ew2, sys.c_bound, csr, vh),
                    pen[keep_v], rem[keep_v], thresh[keep_v], ids[keep_v],
                    None if vb is None else vb[keep_v])


def livefirst_repack(sys: LmmSystem, pen, rem, thresh, ids, vh: int,
                     eh: int, live_elems: int, vb=None) -> Repacked:
    """Halve the drain to ``vh`` flow rows and ``eh`` element rows.  The
    caller decided from counts it already fetched that ``vh`` holds
    every live flow and ``eh`` every one of the ``live_elems`` live
    elements; nothing is read back here.  The rate bounds ``vb``, when
    given, follow the flow rows."""
    if on_cpu(pen, sys.e_w):
        return livefirst_repack_plain(sys, pen, rem, thresh, ids, vh, eh,
                                      live_elems, vb)
    lib = build.load("livefirst_repack", _SIG)
    dev, dtype = pen.device, pen.dtype
    V, E, C, nnz = int(pen.shape[0]), sys.n_e, sys.n_c, sys.csr.nnz
    if vh < 1 or eh < 1:
        raise ValueError(f"repack to empty shapes (vh={vh}, eh={eh})")

    def empty(n, dt):
        return torch.empty(n, dtype=dt, device=dev)
    i32 = torch.int32
    ev2, ec2, ew2 = empty(eh, i32), empty(eh, i32), empty(eh, dtype)
    pen2, rem2, thresh2 = empty(vh, dtype), empty(vh, dtype), \
        empty(vh, dtype)
    ids2 = empty(vh, i32)
    vb2 = None if vb is None else empty(vh, dtype)
    c_ptr2, c_idx2 = empty(C + 1, i32), empty(live_elems, i32)
    v_ptr2, v_idx2 = empty(vh + 1, i32), empty(live_elems, i32)
    flags = (V + E + 2 * nnz + 15) & ~15
    n_blk = -(-max(V, E, nnz) // _SCAN_TILE) + 1
    scratch = empty(flags + 4 * (2 * V + 2 * E + 2 * nnz + n_blk + 4),
                    torch.uint8)
    csr = sys.csr
    rc = lib.livefirst_repack(
        is_double(dtype), V, E, C, nnz, int(vh), int(eh), int(live_elems),
        ptr(sys.e_var), ptr(sys.e_cnst), ptr(sys.e_w), ptr(pen), ptr(rem),
        ptr(thresh), ptr(ids), ptr(csr.c_ptr), ptr(csr.c_idx),
        ptr(csr.v_ptr), ptr(csr.v_idx), ptr(ev2), ptr(ec2), ptr(ew2),
        ptr(pen2), ptr(rem2), ptr(thresh2), ptr(ids2), ptr(c_ptr2),
        ptr(c_idx2), ptr(v_ptr2), ptr(v_idx2), opt_ptr(vb), opt_ptr(vb2),
        ptr(scratch), stream())
    check(rc, "livefirst_repack")
    (COUNT if vb is None else VBOUND_COUNT).n += 1
    return Repacked(
        LmmSystem(ev2, ec2, ew2, sys.c_bound,
                  Csr(c_ptr2, c_idx2, v_ptr2, v_idx2), int(vh)),
        pen2, rem2, thresh2, ids2, vb2)
