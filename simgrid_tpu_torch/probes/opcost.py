"""The op-cost table on the card: the counterpart of
``tools/tpu_opcost.py``, at its 100k-flow shapes (C = 16,384
constraints, 100,000 flows of degree 4, bucketed to E = 524,288 and
V = 131,072).

Each XLA op of the tool gets its PyTorch library call (the library
column) and, beside it, the hand-written kernel that computes the same
function:

* ``gather_flat_E`` / ``gather_2d_V4``: ``torch.take``; K12;
* ``scatter_add``: ``index_add_``; K13's three arms;
* ``scatter_min``: ``scatter_reduce_(..., "amin")``; K13's inorder arm;
* ``scatter_add3``: the three-channel ``index_add_``; K13 (the
  shared-memory arm where the C x 3 totals fit a block);
* ``cumsum_E`` / ``cummin_E``: ``cumsum`` / ``cummin``; K14;
* ``seg_sum_sorted`` / ``seg_min_sorted``: the tool's cumsum (cummin)
  plus boundary gather; K13's inorder arm (the tool's min form is a cost
  stand-in that is not the segment minimum: its library want is its own
  formula, the kernel's the true minimum);
* ``round_current_like`` / ``round_sorted_like``: library glue only;
* ``P8_double`` last: P8's ``x * 2`` on K15's ``probe_double``.

:func:`run_opcost` runs ``pallas_probe``, ``pallas_gather2``,
``pallas_gather3`` and this table.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.probe_gather import ARMS as GATHER_ARMS
from ..kernels.probe_gather import probe_gather, smem_limit_bytes
from ..kernels.probe_loop import probe_double
from ..kernels.probe_scan import probe_scan
from ..kernels.probe_segsum import probe_segsum, segment_csr
from . import data, pallas_gather2, pallas_gather3, pallas_probe
from .common import DTYPES, UNIT_ROUNDOFF, Table, reorder_tol, torch_dtype
from .pallas_probe import segsum_terms
from .timing import sync_ms

PROBE = "opcost"


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "kind": "cpu"}


def round_current_np(rou, vc_cnst, C):
    """``round_current_like`` (tools/tpu_opcost.py:132-148) in numpy."""
    rv = rou[vc_cnst]
    nmin_v = rv.min(axis=1)
    nmin_c = np.full(C, np.inf, rou.dtype)
    np.minimum.at(nmin_c, vc_cnst.ravel(),
                  np.broadcast_to(nmin_v[:, None], vc_cnst.shape).ravel())
    proc = nmin_c[vc_cnst]
    fix = (rv <= proc).all(axis=1)
    contrib = np.stack([np.broadcast_to(fix[:, None].astype(rou.dtype),
                                        vc_cnst.shape).ravel(),
                        np.broadcast_to(nmin_v[:, None],
                                        vc_cnst.shape).ravel(),
                        np.ones(vc_cnst.size, rou.dtype)], axis=-1)
    sums = np.zeros((C, 3), rou.dtype)
    np.add.at(sums, vc_cnst.ravel(), contrib)
    return sums


def round_current_torch(rou, vc_cnst_l, C):
    rv = rou[vc_cnst_l]
    nmin_v = rv.min(dim=1).values
    flat = vc_cnst_l.reshape(-1)
    nmin_c = torch.full((C,), float("inf"), dtype=rou.dtype,
                        device=rou.device).scatter_reduce_(
        0, flat, nmin_v[:, None].expand(vc_cnst_l.shape).reshape(-1),
        "amin")
    proc = nmin_c[vc_cnst_l]
    fix = (rv <= proc).all(dim=1)
    contrib = torch.stack([
        fix[:, None].to(rou.dtype).expand(vc_cnst_l.shape).reshape(-1),
        nmin_v[:, None].expand(vc_cnst_l.shape).reshape(-1),
        torch.ones(flat.shape, dtype=rou.dtype, device=rou.device)], dim=-1)
    return torch.zeros((C, 3), dtype=rou.dtype,
                       device=rou.device).index_add_(0, flat, contrib)


def round_sorted_np(rou, e_cnst, e_w, seg_end, deg):
    """``round_sorted_like`` (tools/tpu_opcost.py:152-170) in numpy."""
    re_ = rou[e_cnst]
    nmin_v = re_.reshape(-1, deg).min(axis=1)
    cm = np.minimum.accumulate(np.repeat(nmin_v, deg))
    nmin_c = cm[np.maximum(seg_end[1:] - 1, 0)]
    proc_e = nmin_c[e_cnst]
    fix_v = (re_.reshape(-1, deg) <= proc_e.reshape(-1, deg)).all(axis=1)
    contrib = np.repeat(np.where(fix_v, nmin_v, 0.0).astype(rou.dtype),
                        deg) * e_w
    cs = np.cumsum(contrib)
    return np.diff(np.concatenate([np.zeros(1, rou.dtype), cs])[seg_end])


def round_sorted_torch(rou, e_cnst_l, e_w, seg_end_l, deg):
    re_ = rou[e_cnst_l]
    nmin_v = re_.reshape(-1, deg).min(dim=1).values
    cm = torch.cummin(nmin_v.repeat_interleave(deg), 0).values
    nmin_c = cm[torch.clamp(seg_end_l[1:] - 1, min=0)]
    proc_e = nmin_c[e_cnst_l]
    fix_v = (re_.reshape(-1, deg) <= proc_e.reshape(-1, deg)).all(dim=1)
    contrib = torch.where(fix_v, nmin_v, torch.zeros_like(nmin_v)) \
        .repeat_interleave(deg) * e_w
    cs = torch.cumsum(contrib, 0)
    return torch.diff(torch.cat([torch.zeros(1, dtype=rou.dtype,
                                             device=rou.device), cs])
                      [seg_end_l])


def opcost_rows(table: Table, scale: float = 1.0,
                dtypes: Sequence[str] = DTYPES) -> List[dict]:
    dev = table.device
    d = data.opcost(scale)
    C, Eb, DEG = d["C"], d["Eb"], d["DEG"]
    ec_np, vc_np, se_np = d["e_cnst"], d["vc_cnst"], d["seg_end"]
    e_cnst = torch.from_numpy(ec_np).to(dev)
    vc = torch.from_numpy(vc_np).to(dev)
    ec_l, vc_l = e_cnst.long(), vc.long()
    seg_end_l = torch.from_numpy(se_np).to(dev).long()
    csr = segment_csr(e_cnst, C)
    terms = segsum_terms(csr[0])
    smem = smem_limit_bytes() if dev.type == "cuda" else None
    out = []
    for name in dtypes:
        dt = torch_dtype(name)
        u = UNIT_ROUNDOFF[dt]
        rou_np = data.as_dtype(d["rou"], dt)
        w_np = data.as_dtype(d["e_w"], dt)
        rou = torch.from_numpy(rou_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        es = rou.element_size()
        m = table.measure

        def gather_row(label, ix, ix_np, ix_l):
            return m(PROBE, label, dt,
                     {a: (lambda a=a: probe_gather(rou, ix, a))
                      for a in GATHER_ARMS},
                     rou_np[ix_np], rou.numel() * es + ix.numel() * (4 + es),
                     library=lambda: torch.take(rou, ix_l),
                     library_name="torch.take")
        out += gather_row("gather_flat_E", e_cnst, ec_np, ec_l)
        out += gather_row("gather_2d_V4", vc, vc_np, vc_l)

        seg_bytes = Eb * (4 + es) + C * es
        want = np.zeros(C, w_np.dtype)
        np.add.at(want, ec_np, w_np)
        tol = reorder_tol(want, terms, dt)
        out += m(PROBE, "scatter_add", dt,
                 {a: (lambda a=a: probe_segsum(e_cnst, w, C, a, csr=csr))
                  for a in ("atomic", "smem_atomic", "inorder")},
                 want, seg_bytes, inexact={"atomic": tol, "smem_atomic": tol},
                 library=lambda: torch.zeros(C, dtype=dt, device=dev)
                 .index_add_(0, ec_l, w), library_name="index_add_")
        want_min = np.full(C, np.inf, w_np.dtype)
        np.minimum.at(want_min, ec_np, w_np)
        out += m(PROBE, "scatter_min", dt,
                 {"inorder": lambda: probe_segsum(e_cnst, w, C, "inorder",
                                                  "min", csr)},
                 want_min, seg_bytes,
                 library=lambda: torch.full((C,), float("inf"), dtype=dt,
                                            device=dev).scatter_reduce_(
                     0, ec_l, w, "amin"),
                 library_name="scatter_reduce_ amin")
        w3 = torch.stack([w, w, w], dim=-1)
        w3_np = np.stack([w_np, w_np, w_np], axis=-1)
        want3 = np.zeros((C, 3), w_np.dtype)
        np.add.at(want3, ec_np, w3_np)
        tol3 = reorder_tol(want3, terms[:, None], dt)
        arms3 = ["atomic", "inorder"]
        if smem is None or C * 3 * es <= smem:
            arms3.insert(1, "smem_atomic")
        out += m(PROBE, "scatter_add3", dt,
                 {a: (lambda a=a: probe_segsum(e_cnst, w3, C, a, csr=csr))
                  for a in arms3},
                 want3, Eb * (4 + 3 * es) + 3 * C * es,
                 inexact={"atomic": tol3, "smem_atomic": tol3},
                 library=lambda: torch.zeros((C, 3), dtype=dt, device=dev)
                 .index_add_(0, ec_l, w3), library_name="index_add_ [C, 3]")

        want_cs = np.cumsum(w_np)
        out += m(PROBE, "cumsum_E", dt,
                 {a: (lambda a=a: probe_scan(w, a)) for a in ("seq", "block")},
                 want_cs, 2 * Eb * es,
                 inexact={"block": reorder_tol(want_cs, np.arange(1, Eb + 1),
                                               dt)},
                 library=lambda: torch.cumsum(w, 0),
                 library_name="torch.cumsum")
        out += m(PROBE, "cummin_E", dt,
                 {a: (lambda a=a: probe_scan(w, a, "min"))
                  for a in ("seq", "block")},
                 np.minimum.accumulate(w_np), 2 * Eb * es,
                 library=lambda: torch.cummin(w, 0).values,
                 library_name="torch.cummin")
        zero = torch.zeros(1, dtype=dt, device=dev)
        lib_ss_np = np.diff(np.concatenate([[0], np.cumsum(w_np)])
                            .astype(w_np.dtype)[se_np])
        out += m(PROBE, "seg_sum_sorted", dt,
                 {"inorder": lambda: probe_segsum(e_cnst, w, C, "inorder",
                                                  csr=csr)},
                 want, seg_bytes,
                 library=lambda: torch.diff(
                     torch.cat([zero, torch.cumsum(w, 0)])[seg_end_l]),
                 library_name="cumsum + boundary gather + diff",
                 library_want=lib_ss_np)
        lib_sm_np = np.minimum.accumulate(w_np)[
            np.maximum(se_np[1:] - 1, 0)]
        out += m(PROBE, "seg_min_sorted", dt,
                 {"inorder": lambda: probe_segsum(e_cnst, w, C, "inorder",
                                                  "min", csr)},
                 want_min, seg_bytes,
                 library=lambda: torch.take(
                     torch.cummin(w, 0).values,
                     torch.clamp(seg_end_l[1:] - 1, min=0)),
                 library_name="cummin + boundary gather (the tool's cost "
                              "stand-in)",
                 library_want=lib_sm_np)

        want_rc = round_current_np(rou_np, vc_np, C)
        cnt = np.bincount(vc_np.ravel(), minlength=C)[:, None]
        out += m(PROBE, "round_current_like", dt,
                 {"glue": lambda: round_current_torch(rou, vc_l, C)},
                 want_rc, rou.numel() * es + vc.numel() * 4 + 3 * C * es,
                 inexact={"glue": reorder_tol(want_rc, np.maximum(cnt, 1),
                                              dt)})
        want_rs = round_sorted_np(rou_np, ec_np, w_np, se_np, DEG)
        cs_max = float(np.max(np.abs(np.cumsum(w_np * 2.0))))
        out += m(PROBE, "round_sorted_like", dt,
                 {"glue": lambda: round_sorted_torch(rou, ec_l, w, seg_end_l,
                                                     DEG)},
                 want_rs, rou.numel() * es + Eb * (4 + es) + C * (4 + es),
                 inexact={"glue": np.full(want_rs.shape,
                                          4.0 * Eb * u * cs_max)})
        x = torch.ones((256, 128), dtype=dt, device=dev)
        out += m(PROBE, "P8_double", dt, {"kernel": lambda: probe_double(x)},
                 np.full((256, 128), 2.0, rou_np.dtype), 2 * x.numel() * es,
                 library=lambda: x * 2, library_name="x * 2")
    return out


def run_opcost(device: DeviceLike = None, scale: float = 1.0,
               dtypes: Sequence[str] = DTYPES) -> Dict:
    """P1-P8 and the op-cost table: ``{"device", "sync_ms", "rows",
    "ok"}``, one row per probe, op, arm and dtype."""
    dev = resolve_device(device)
    table = Table(dev)
    s = sync_ms(dev)
    for run in (pallas_probe.run, pallas_gather2.run, pallas_gather3.run,
                opcost_rows):
        run(table, scale, dtypes)
    return {"device": device_info(dev), "sync_ms": s, "rows": table.rows,
            "ok": all(r["ok"] for r in table.rows)}
