"""K14: the inclusive scan along the lanes of each row, for the op-cost
probe.

``out[r, j]`` is the sum (``op="sum"``) or the minimum (``op="min"``) of
``x[r, :j+1]``, for ``x`` of shape ``[R, W]`` or ``[W]`` (one row).

Replaces P6 ``tools/tpu_pallas_gather3.py`` ``ck`` (``:93``,
``jnp.cumsum(w, axis=1)`` over ``[32, 16384]`` inside a kernel) and
``tools/tpu_opcost.py``'s ``cumsum_E`` and ``cummin_E`` (one row of
524,288).  The CUDA source is ``csrc/probe_scan.cu``.

Arms, each counted under ``probe_scan_<arm>``:

* ``seq``: one thread folds each row from left to right; it equals
  ``np.cumsum`` (and ``np.minimum.accumulate``) by bits;
* ``block``: ``csrc/scan.cuh``'s three passes over every row's tiles at
  once.  Its sum adds in the tiles' order, so it is held to a tolerance;
  its minimum is exact.

The plain version folds the lanes one column at a time, every row at
once, so its sums are the sequential fold's on any device.
"""

from __future__ import annotations

import torch

from . import build
from .common import (I, P, check, counter, is_double, on_cpu, opt_ptr, ptr,
                     stream)

ARMS = ("seq", "block")
OPS = ("sum", "min")
COUNTS = {a: counter(f"probe_scan_{a}") for a in ARMS}
#: lanes of one tile of the block arm (SCAN_TILE in csrc/scan.cuh)
TILE = 2048

_SIG = {"probe_scan": [I, I, I, I, I, P, P, P, P]}


def probe_scan_plain(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(rows)
    if rows.shape[1]:
        acc = rows[:, 0].clone()
        out[:, 0] = acc
        for j in range(1, rows.shape[1]):
            acc = acc + rows[:, j] if op == "sum" \
                else torch.minimum(acc, rows[:, j])
            out[:, j] = acc
    return out.reshape(x.shape)


def probe_scan(x: torch.Tensor, arm: str = "seq",
               op: str = "sum") -> torch.Tensor:
    """The inclusive scan of ``x`` ([R, W] or [W]) along its last axis."""
    if arm not in ARMS or op not in OPS:
        raise ValueError(f"probe_scan arm {arm!r} / op {op!r}")
    if x.dim() not in (1, 2):
        raise ValueError("probe_scan takes [R, W] or [W]")
    if on_cpu(x):
        return probe_scan_plain(x, op)
    dbl = is_double(x.dtype)
    W = int(x.shape[-1])
    R = int(x.numel() // W) if W else 0
    if arm == "block" and R > 65535:
        raise ValueError("the block arm scans at most 65,535 rows")
    out = torch.empty_like(x)
    tsum = None
    if arm == "block" and R and W:
        tsum = torch.empty(R * ((W + TILE - 1) // TILE), dtype=x.dtype,
                           device=x.device)
    lib = build.load("probe_scan", _SIG)
    rc = lib.probe_scan(dbl, ARMS.index(arm), OPS.index(op), R, W, ptr(x),
                        ptr(out), opt_ptr(tsum), stream())
    check(rc, f"probe_scan ({arm}, {op})")
    COUNTS[arm].n += 1
    return out
