"""K13: the segment sum (or min) of the op-cost probe.

``out[c, k]`` is the sum (``op="sum"``) or the minimum (``op="min"``)
of ``w[i, k]`` over the elements ``i`` with ``idx[i] == c``; empty rows
give 0 (sum) or +inf (min), as ``zeros(C).at[idx].add(w)`` and
``full(C, inf).at[idx].min(w)`` do.  ``w`` is shaped like ``idx``, or
like it with a trailing channel axis (``tools/tpu_opcost.py``'s
three-channel ``scatter_add3``: ``[E, 3]`` into ``[C, 3]``).

Replaces P2 ``tools/tpu_pallas_probe.py`` ``sk`` (``:80``) and P7
``tools/tpu_pallas_gather3.py`` ``mk`` (``:109``, the one-hot matmul
form), and ``tools/tpu_opcost.py``'s ``scatter_add``, ``scatter_min``,
``scatter_add3``, ``seg_sum_sorted`` and ``seg_min_sorted``.  The CUDA
source is ``csrc/probe_segsum.cu``.

Arms, each counted under ``probe_segsum_<arm>``:

* ``atomic``: a global atomicAdd per element (sum only);
* ``smem_atomic``: per-block totals in shared memory, then flushed (sum
  only; the C x ch totals must fit a block's shared memory);
* ``inorder``: one warp per row folds the row's elements in element
  order over a CSR (:func:`segment_csr`, which the caller builds once,
  outside any timed window, as ``tools/tpu_opcost.py:70-73`` precomputes
  ``seg_end``).  It equals ``np.add.at`` by bits; the two atomic arms'
  order changes from run to run, so they are held to a tolerance.

The plain version folds every row in element order too, column ``j`` of
every row at once (the rows padded to the longest with the fold's
identity), so it equals ``np.add.at`` by bits on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.csr import build_csr
from . import build
from .common import (I, L, P, check, counter, is_double, on_cpu, opt_ptr,
                     ptr, stream)
from .probe_gather import smem_limit_bytes

ARMS = ("atomic", "smem_atomic", "inorder")
OPS = ("sum", "min")
COUNTS = {a: counter(f"probe_segsum_{a}") for a in ARMS}

_SIG = {"probe_segsum": [I, I, I, L, I, I, P, P, P, P, P, P]}

SegCsr = Tuple[torch.Tensor, torch.Tensor]


def segment_csr(idx: torch.Tensor, c: int) -> SegCsr:
    """``(c_ptr [c+1], c_idx)``: each row's elements in increasing
    element order (``ops/csr.build_csr`` over every element: its weights
    are ones, so none is left out)."""
    flat = idx.reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    csr = build_csr(flat, flat, ones, c, c)
    return csr.c_ptr, csr.c_idx


def _channels(idx: torch.Tensor, w: torch.Tensor) -> int:
    """0 when ``w`` is shaped like ``idx`` (one value an element), else
    the trailing channel count of ``w`` [*idx.shape, ch]."""
    if tuple(w.shape) == tuple(idx.shape):
        return 0
    if w.dim() == idx.dim() + 1 and tuple(w.shape[:-1]) == tuple(idx.shape):
        return int(w.shape[-1])
    raise ValueError(f"w {tuple(w.shape)} must be shaped like idx "
                     f"{tuple(idx.shape)}, with or without a channel axis")


def probe_segsum_plain(idx: torch.Tensor, w: torch.Tensor, c: int,
                       op: str = "sum", csr: Optional[SegCsr] = None
                       ) -> torch.Tensor:
    c_ptr, c_idx = segment_csr(idx, c) if csr is None else csr
    chans = _channels(idx, w)
    ch = max(chans, 1)
    wf = w.reshape(-1, ch)
    lens = (c_ptr[1:] - c_ptr[:-1]).long()
    beg = c_ptr[:-1].long()
    ident = 0.0 if op == "sum" else float("inf")
    acc = torch.full((c, ch), ident, dtype=w.dtype, device=w.device)
    width = int(lens.max()) if c > 0 and c_idx.numel() else 0
    for j in range(width):
        on = lens > j
        pos = torch.where(on, beg + j, torch.zeros_like(beg))
        x = wf[c_idx[pos].long()]
        x = torch.where(on[:, None], x, torch.full_like(x, ident))
        acc = acc + x if op == "sum" else torch.minimum(acc, x)
    return acc if chans else acc.reshape(c)


def probe_segsum(idx: torch.Tensor, w: torch.Tensor, c: int,
                 arm: str = "inorder", op: str = "sum",
                 csr: Optional[SegCsr] = None) -> torch.Tensor:
    """The segment reduction of ``w`` (shaped like ``idx``, int32
    entries in ``[0, c)`` of any shape, or like it with a trailing
    channel axis ``ch``) into ``[c]`` or ``[c, ch]``.
    The inorder arm walks ``csr`` (:func:`segment_csr`; built here when
    None)."""
    if arm not in ARMS or op not in OPS:
        raise ValueError(f"probe_segsum arm {arm!r} / op {op!r}")
    n = idx.numel()
    chans = _channels(idx, w)
    ch = max(chans, 1)
    if idx.dtype != torch.int32:
        raise TypeError("probe_segsum takes an int32 index")
    if op != "sum" and arm != "inorder":
        raise ValueError(f"the {arm} arm adds only")
    if on_cpu(idx, w):
        return probe_segsum_plain(idx, w, c, op, csr)
    dbl = is_double(w.dtype)
    if arm == "smem_atomic" and \
            c * ch * w.element_size() > smem_limit_bytes():
        raise ValueError(
            f"the smem_atomic arm's {c} x {ch} totals do not fit a block's "
            f"{smem_limit_bytes()} B of shared memory")
    if arm == "inorder" and csr is None:
        csr = segment_csr(idx, c)
    out = torch.empty((c, ch) if chans else (c,), dtype=w.dtype,
                      device=w.device)
    c_ptr, c_idx = csr if arm == "inorder" else (None, None)
    lib = build.load("probe_segsum", _SIG)
    rc = lib.probe_segsum(dbl, ARMS.index(arm), OPS.index(op), n, c, ch,
                          ptr(idx), ptr(w), opt_ptr(c_ptr), opt_ptr(c_idx),
                          ptr(out), stream())
    check(rc, f"probe_segsum ({arm}, {op})")
    COUNTS[arm].n += 1
    return out
