"""Per-element against per-op cost on the card: the counterpart of
``tools/tpu_scaling_probe.py``.

1. Element scaling: K12's gather (``global`` arm) and K13's segment sum
   (``atomic`` arm) of ``[N/4, 4]`` from a 16,384-entry table, N from
   65,536 to 2,097,152, beside ``torch.take`` and ``index_add_``.  Time
   that grows with N means a per-element cost; flat time means the
   launch dominates.
2. Op-count scaling: K in {1, 2, 4, 8} dependent gathers of
   ``[131072, 4]`` (K15's round, from the same table), as K launches,
   as one replayed CUDA graph, as one graph of a conditional WHILE node
   (K16's mechanism) and as one cooperative kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.probe_gather import probe_gather
from ..kernels.probe_segsum import probe_segsum, segment_csr
from . import data
from .common import DTYPES, Table, reorder_tol, torch_dtype
from .opcost import device_info
from .pallas_probe import loop_arms, loop_bytes, loop_want, segsum_terms
from .timing import sync_ms

PROBE = "scaling"
CHAIN = (1, 2, 4, 8)


def run_scaling(device: DeviceLike = None, scale: float = 1.0,
                dtypes: Sequence[str] = DTYPES) -> Dict:
    """``{"device", "sync_ms", "rows", "ok"}`` of both scalings."""
    dev = resolve_device(device)
    table = Table(dev)
    d = data.scaling(scale)
    C = d["C"]
    inputs = {n: (torch.from_numpy(ix).to(dev), ix, w)
              for n, (ix, w) in d["sizes"].items()}
    csrs = {n: segsum_terms(segment_csr(ix, C)[0])
            for n, (ix, _, _) in inputs.items()}
    ops_np = d["idx_ops"]
    ops = torch.from_numpy(ops_np).to(dev)
    for name in dtypes:
        dt = torch_dtype(name)
        tab_np = data.as_dtype(d["tab"], dt)
        tab = torch.from_numpy(tab_np).to(dev)
        es = tab.element_size()
        for n, (ix, ix_np, w_d) in inputs.items():
            ix_l = ix.long().reshape(-1)
            table.measure(PROBE, f"gather_{n}", dt,
                          {"global": lambda ix=ix: probe_gather(tab, ix)},
                          tab_np[ix_np], C * es + n * (4 + es),
                          library=lambda ix_l=ix_l: torch.take(tab, ix_l),
                          library_name="torch.take", n=n)
            w_np = data.as_dtype(w_d, dt)
            w = torch.from_numpy(w_np).to(dev)
            want = np.zeros(C, w_np.dtype)
            np.add.at(want, ix_np.ravel(), w_np.ravel())
            wf = w.reshape(-1)
            table.measure(
                PROBE, f"scatter_{n}", dt,
                {"atomic": lambda ix=ix, w=w: probe_segsum(ix, w, C,
                                                            "atomic")},
                want, n * (4 + es) + C * es,
                inexact={"atomic": reorder_tol(want, csrs[n], dt)},
                library=lambda ix_l=ix_l, wf=wf: torch.zeros(
                    C, dtype=dt, device=dev).index_add_(0, ix_l, wf),
                library_name="index_add_", n=n)
        for k in CHAIN:
            table.measure(PROBE, f"chain{k}_gathers", dt,
                          loop_arms(tab, ops, k), loop_want(tab_np, ops_np, k),
                          loop_bytes(tab, ops, k), rounds=k)
    return {"device": device_info(dev), "sync_ms": sync_ms(dev),
            "rows": table.rows, "ok": all(r["ok"] for r in table.rows)}
