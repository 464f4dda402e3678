"""K4: the drain's on-device repack to halved shapes.

Replaces ``simgrid_tpu/ops/lmm_jax.py`` ``_stable_livefirst_perm``
(``:716-731``) and ``simgrid_tpu/ops/lmm_drain.py`` ``_drain_repack``
(``:606-644``) with ``_repack_vbound`` (``:647-651``: the rate bounds
follow the flow rows' permutation when the drain has bounds); the CUDA
source is ``csrc/livefirst_repack.cu``.  It also re-derives both row
indexes of the halved system.

A call is three launches over single-pass stable compactions whose
tiles publish their counts in status words.  Those words and the
kernel's integer scratch live in buffers kept here per device, sized by
the largest shapes seen (:func:`_scratch`): the status words are zero
between calls (each launch zeroes the words of the one before it), so a
call allocates only its outputs.  A call that fails to
launch drops the scratch, and the next call starts from fresh zeros.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.csr import Csr, build_csr
from . import build
from .common import (I, LmmSystem, P, check, counter, is_double, on_cpu,
                     ptr_array, stream)

COUNT = counter("livefirst_repack")
#: launches that carried the rate bounds along
VBOUND_COUNT = counter("livefirst_repack_vbound")

#: buffers handed to the C entry as one pointer array, and the rows a
#: tile ranks (keep in sync with csrc/livefirst_repack.cu)
N_PTRS = 24
RP_TILE = 1024

_SIG = {"livefirst_repack": [I] * 8 + [P, I, P, P, P]}

#: per device: (status words int64, zero between calls; int32 work)
_SCRATCH: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


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
    status, work = _scratch(dev, V, E, nnz)
    csr = sys.csr
    ptrs = ptr_array((
        sys.e_var, sys.e_cnst, sys.e_w, pen, rem, thresh, ids, vb,
        csr.c_ptr, csr.c_idx, csr.v_ptr, csr.v_idx,
        ev2, ec2, ew2, pen2, rem2, thresh2, ids2, vb2,
        c_ptr2, c_idx2, v_ptr2, v_idx2))
    rc = lib.livefirst_repack(
        is_double(dtype), V, E, C, nnz, int(vh), int(eh), int(live_elems),
        ptrs, N_PTRS, status.data_ptr(), work.data_ptr(), stream())
    if rc != 0:
        _SCRATCH.pop(str(dev), None)
    check(rc, "livefirst_repack")
    (COUNT if vb is None else VBOUND_COUNT).n += 1
    return Repacked(
        LmmSystem(ev2, ec2, ew2, sys.c_bound,
                  Csr(c_ptr2, c_idx2, v_ptr2, v_idx2), int(vh)),
        pen2, rem2, thresh2, ids2, vb2)


def _tiles(n: int) -> int:
    return max(1, -(-n // RP_TILE))


def _scratch(dev: torch.device, V: int, E: int, nnz: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's status words (a tile of each partition and a start
    counter each) and int32 work (V + E + 2 nnz + 4), grown (the status
    words zeroed) when a call at these shapes needs more."""
    n_st = _tiles(V) + _tiles(E) + 2 * _tiles(nnz) + 4
    n_wk = V + E + 2 * nnz + 4
    key = str(dev)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_st or have[1].numel() < n_wk:
        n_st_, n_wk_ = n_st, n_wk
        if have is not None:
            n_st_ = max(n_st_, have[0].numel())
            n_wk_ = max(n_wk_, have[1].numel())
        have = (torch.zeros(n_st_, dtype=torch.int64, device=dev),
                torch.empty(n_wk_, dtype=torch.int32, device=dev))
        _SCRATCH[key] = have
    return have
