"""P5-P7 on the card: the counterpart of ``tools/tpu_pallas_gather3.py``.

* P5 (``k``, ``:69``): the gather at table widths Cw in {128, 2048,
  16384}, ``idx % Cw`` as ``[E/Cw, Cw]`` (E = 524,288), on K12's two
  arms; the library column is ``xla_tala_w16384``'s form at every
  width: ``torch.gather`` on the table broadcast to ``[E/Cw, Cw]``;
* P6 (``ck``, ``:93``): the inclusive sum along the lanes of
  ``[32, 16384]`` on K14's two arms, beside ``torch.cumsum``;
* P7 (``mk``, ``:109``): the segment sum of E weights into C rows (the
  tool's one-hot matmul) on K13's three arms, beside ``index_add_``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..kernels.probe_gather import ARMS as GATHER_ARMS
from ..kernels.probe_gather import probe_gather
from ..kernels.probe_scan import probe_scan
from ..kernels.probe_segsum import probe_segsum, segment_csr
from . import data
from .common import DTYPES, Table, reorder_tol, torch_dtype
from .pallas_probe import segsum_terms


def run(table: Table, scale: float = 1.0,
        dtypes: Sequence[str] = DTYPES) -> List[dict]:
    dev = table.device
    d = data.pallas_gather3(scale)
    C, E = d["C"], d["E"]
    idx_np = d["idx"]
    idx = torch.from_numpy(idx_np).to(dev)
    idx_l = idx.long()
    csr = segment_csr(idx, C)
    terms = segsum_terms(csr[0])
    out = []
    for name in dtypes:
        dt = torch_dtype(name)
        tab_np = data.as_dtype(d["tab"], dt)
        tab = torch.from_numpy(tab_np).to(dev)
        es = tab.element_size()
        for cw in d["widths"]:
            R = E // cw
            iw_np = (idx_np % cw).reshape(R, cw)
            iw = torch.from_numpy(iw_np).to(dev)
            tw = tab[:cw]
            tb = tw.reshape(1, cw).expand(R, cw)
            iw_l = iw.long()
            out += table.measure(
                "pallas_gather3", f"P5_dg_w{cw}", dt,
                {a: (lambda a=a, tw=tw, iw=iw: probe_gather(tw, iw, a))
                 for a in GATHER_ARMS},
                tab_np[:cw][iw_np], cw * es + iw.numel() * (4 + es),
                library=lambda tb=tb, iw_l=iw_l: torch.gather(tb, 1, iw_l),
                library_name="torch.gather (xla_tala)")
        x_np = data.as_dtype(d["w_cum"], dt)
        x = torch.from_numpy(x_np).to(dev)
        W = x.shape[1]
        want = np.cumsum(x_np, axis=1)
        out += table.measure(
            "pallas_gather3", "P6_cumsum_axis1", dt,
            {a: (lambda a=a: probe_scan(x, a)) for a in ("seq", "block")},
            want, 2 * x.numel() * es,
            inexact={"block": reorder_tol(want, np.arange(1, W + 1), dt)},
            library=lambda: torch.cumsum(x, 1), library_name="torch.cumsum")
        w_np = data.as_dtype(d["w_seg"], dt)
        w = torch.from_numpy(w_np).to(dev)
        want = np.zeros(C, w_np.dtype)
        np.add.at(want, idx_np, w_np)
        out += table.measure(
            "pallas_gather3", "P7_onehot_segsum", dt,
            {a: (lambda a=a: probe_segsum(idx, w, C, a, csr=csr))
             for a in ("atomic", "smem_atomic", "inorder")},
            want, E * (4 + es) + C * es,
            inexact={a: reorder_tol(want, terms, dt)
                     for a in ("atomic", "smem_atomic")},
            library=lambda: torch.zeros(C, dtype=dt, device=dev).index_add_(
                0, idx_l, w),
            library_name="index_add_")
    return out
