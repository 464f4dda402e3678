"""K11's fused entries against the JAX package's programs, on the CPU,
bit for bit (tolerance 0): a fleet's birth (``_materialize``,
``_materialize_ew``, the threshold and dtype casts, a collective fleet's
birth rows) and an admission (``_admit_lane_state``,
``_admit_lane_tape``, ``_admit_lane_coll``, ``_admit_lane_ew``), for
float64 and float32 fleets, ``done_mode`` "rel" and "abs", with pad
slots in every payload row; the packer's refusals of slot rows that are
not strictly increasing; and the packed payload's layout against
``csrc/fleet_payload.cuh``.  Shapes are small (12 constraints, 20 flows,
48 elements, 3 replicas).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simgrid_tpu.ops import lmm_batch as jb
from simgrid_tpu_torch.kernels import common as kc
from simgrid_tpu_torch.kernels import fleet_materialize as k11
from simgrid_tpu_torch.ops import lmm_batch as pb

C, V, E, B = 12, 20, 48, 3
EPS = 1e-4
CSRC = Path(__file__).resolve().parents[1] / "simgrid_tpu_torch" / "csrc"


def base_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 10.0, C), rng.uniform(1e3, 1e6, V),
            rng.uniform(1e2, 1e6, V), rng.uniform(0.5, 2.0, V),
            rng.uniform(0.5, 1.5, E))


def specs(seed=1):
    """Three replicas, each with fewer overrides of every kind than the
    payload's widths below, so that every row ends in pads."""
    rng = np.random.default_rng(seed)

    def pick(n, k):
        return sorted(rng.choice(n, k, replace=False).tolist())
    out = []
    for k in (1, 2, 3):
        out.append(pb.ReplicaOverrides(
            float(rng.uniform(0.5, 1.5)), float(rng.uniform(0.5, 1.5)),
            {s: float(rng.uniform(0.1, 3.0)) for s in pick(C, k)},
            {s: float(rng.uniform(0.1, 3.0)) for s in pick(V, k)},
            pick(V, k),
            {s: float(rng.uniform(0.1, 3.0)) for s in pick(E, k)}))
    return out


WIDE = (4, 4, 4)


def fleet_tensors(dtype, fill=0.5):
    td = torch.float64 if dtype == np.float64 else torch.float32
    out = [torch.full((B, n), fill, dtype=td) for n in (C, V, V, V)]
    ew = torch.full((B, E), fill, dtype=td)
    return td, out, ew


def coll_tensors(rng):
    pred0 = rng.integers(0, 4, V).astype(np.int32)
    ready0 = np.where(rng.random(V) < 0.3, 1e-3, np.inf)
    coll = (torch.full((B, V), -7, dtype=torch.int32),
            torch.full((B, V), 0.25, dtype=torch.float64),
            torch.full((B, 2), 0.75, dtype=torch.float64))
    return (pred0, ready0), coll


CASES = [(np.float64, "rel", False), (np.float64, "abs", True),
         (np.float32, "rel", False), (np.float32, "abs", False)]


@pytest.mark.parametrize("dtype,mode,coll", CASES)
def test_fused_birth_equals_jax(dtype, mode, coll):
    """One ``materialize`` call (state, weights, collective rows) equals
    JAX's ``_materialize`` with the birth's casts, ``_materialize_ew``
    and the collective birth rows, by bits."""
    cb0, sz0, rem0, pen0, ew0 = base_arrays()
    ovs = specs()
    payload = pb._pack_overrides(ovs, C, V, WIDE)
    ei, ewv = pb._pack_elem_w(ovs, E, dtype, 4)
    for a, n in ((payload[2], C), (payload[4], V), (payload[6], V),
                 (ei, E)):
        assert (a[:, -1] == n).all()
    td, out, ew = fleet_tensors(dtype)
    base_t = [torch.from_numpy(a) for a in (cb0, sz0, rem0, pen0)]
    base_ew = torch.from_numpy(ew0.astype(dtype))
    kw = {}
    if coll:
        rows, ct = coll_tensors(np.random.default_rng(2))
        kw["coll"] = (ct, tuple(torch.from_numpy(r) for r in rows))
    k11.materialize(base_t, payload, out, EPS, mode == "rel",
                    ew=(base_ew, ew, ei, ewv), **kw)
    cb64, sz64, rem64, pen64 = jb._materialize(cb0, sz0, rem0, pen0,
                                               *payload)
    th64 = EPS * sz64 if mode == "rel" else np.full(sz64.shape, EPS)
    for got, want in zip(out, (cb64, pen64, rem64, th64)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(dtype))
    want_ew = jb._materialize_ew(ew0.astype(dtype), ei, ewv)
    assert np.array_equal(ew.numpy(), np.asarray(want_ew))
    assert not np.array_equal(ew.numpy()[0], ew0.astype(dtype))
    if coll:
        pred, ready, clk = ct
        assert np.array_equal(pred.numpy(), np.broadcast_to(rows[0],
                                                            (B, V)))
        assert np.array_equal(ready.numpy(), np.broadcast_to(rows[1],
                                                             (B, V)))
        assert not clk.numpy().any()


@pytest.mark.parametrize("dtype,mode,coll", CASES)
def test_fused_admission_equals_jax(dtype, mode, coll):
    """One ``admit`` call into row 1 of a live fleet (state, tape row,
    collective rows, weight row) equals ``_admit_lane_state``,
    ``_admit_lane_tape``, ``_admit_lane_coll`` and ``_admit_lane_ew``,
    by bits, and leaves the other rows as they were."""
    rng = np.random.default_rng(4)
    cb0, sz0, rem0, pen0, ew0 = base_arrays(5)
    td, out, ew = fleet_tensors(dtype)
    for t in (*out, ew):
        t.copy_(torch.from_numpy(rng.uniform(0, 1, tuple(t.shape))))
    before = [t.clone() for t in (*out, ew)]
    b = 1
    ov = specs(6)[2]
    widths = tuple(pb._pow2_bucket(n) + 1 for n in (
        len(ov.link_scale), len(ov.flow_scale), len(ov.dead_flows)))
    payload = pb._pack_overrides([ov], C, V, widths)
    ei, ewv = pb._pack_elem_w([ov], E, dtype, 8)
    T = 8
    tape = tuple(torch.from_numpy(a) for a in (
        rng.uniform(0, 1, (B, T)), rng.integers(0, C, (B, T)).astype(
            np.int32), rng.uniform(0, 1, (B, T)).astype(dtype)))
    # three entries: the entry pads the row to T as JAX's host does
    entries = (np.array([0.1, 0.2, 0.3]), np.array([4, 1, 7], np.int32),
               np.full(3, 0.05).astype(dtype))
    row_t = np.full(T, np.inf)
    row_s = np.full(T, C, np.int32)
    row_v = np.zeros(T)
    row_t[:3], row_s[:3], row_v[:3] = entries
    row_vd = row_v.astype(dtype)
    tape_before = [t.clone() for t in tape]
    base_t = [torch.from_numpy(a) for a in (cb0, sz0, rem0, pen0)]
    base_ew = torch.from_numpy(ew0.astype(dtype))
    kw = {}
    if coll:
        rows, ct = coll_tensors(rng)
        coll_before = [t.clone() for t in ct]
        kw["coll"] = (ct, tuple(torch.from_numpy(r) for r in rows))
    k11.admit(base_t, payload, out, b, EPS, mode == "rel",
              ew=(base_ew, ew, ei, ewv), tape=(tape, entries), **kw)
    want = jb._admit_lane_state(
        cb0, sz0, rem0, pen0, payload[0][0], payload[1][0],
        *(a[0] for a in payload[2:]), *(t.numpy() for t in before[:4]),
        np.int32(b), np.float64(EPS), done_rel=mode == "rel")
    for got, w in zip(out, want):
        assert np.array_equal(got.numpy(), np.asarray(w))
    want_ew = jb._admit_lane_ew(ew0.astype(dtype), before[4].numpy(), ei[0],
                                ewv[0], np.int32(b))
    assert np.array_equal(ew.numpy(), np.asarray(want_ew))
    want_tape = jb._admit_lane_tape(*(t.numpy() for t in tape_before),
                                    np.full(B, 3, np.int32), row_t, row_s,
                                    row_vd, np.int32(b))
    for got, w in zip(tape, want_tape[:3]):
        assert np.array_equal(got.numpy(), np.asarray(w))
    for got, old in zip((*out, ew), before):
        assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
        assert not torch.equal(got[b], old[b])
    if coll:
        want_coll = jb._admit_lane_coll(*(t.numpy() for t in coll_before),
                                        *rows, np.int32(b))
        for got, w in zip(ct, want_coll):
            assert np.array_equal(got.numpy(), np.asarray(w))


def _payload_with(which, kind):
    ovs = specs()
    payload = [a.copy() for a in pb._pack_overrides(ovs, C, V, WIDE)]
    ei, ewv = pb._pack_elem_w(ovs, E, np.float64, 4)
    arrays = {"li": payload[2], "fi": payload[4], "di": payload[6],
              "ei": ei}
    a = arrays[which]
    row = a[2]                     # three live slots, one pad
    if kind == "unsorted":
        row[[0, 1]] = row[[1, 0]]
    elif kind == "duplicated":
        row[1] = row[0]
    elif kind == "pad_first":
        row[[0, 3]] = row[[3, 0]]
    else:
        row[0] = -1
    return payload, ei, ewv


@pytest.mark.parametrize("kind", ["unsorted", "duplicated", "pad_first",
                                  "negative"])
@pytest.mark.parametrize("which", ["li", "fi", "di", "ei"])
def test_packer_refuses_unsorted_and_duplicated_slots(which, kind):
    """Every slot row must be strictly increasing with its pads last: the
    entry raises ``ValueError`` before it writes anything."""
    payload, ei, ewv = _payload_with(which, kind)
    cb0, sz0, rem0, pen0, ew0 = base_arrays()
    td, out, ew = fleet_tensors(np.float64)
    base_t = [torch.from_numpy(a) for a in (cb0, sz0, rem0, pen0)]
    with pytest.raises(ValueError):
        k11.materialize(base_t, payload, out, EPS, True,
                        ew=(torch.from_numpy(ew0), ew, ei, ewv))
    for t in (*out, ew):
        assert bool((t == 0.5).all())


def _cuh_defines():
    out = {}
    for m in re.finditer(r"^#define (\w+) (\d+)",
                         (CSRC / "fleet_payload.cuh").read_text(), re.M):
        out[m.group(1)] = int(m.group(2))
    return out


def test_payload_layout_matches_cu_defines():
    """The packed buffer holds every part at its offset, in the order of
    ``csrc/fleet_payload.cuh``'s part numbers, each on an ``FP_ALIGN``
    boundary, absent parts taking no room."""
    defs = _cuh_defines()
    names = [n for n in defs if n not in ("FP_PARTS", "FP_ALIGN")]
    assert sorted(defs[n] for n in names) == list(range(defs["FP_PARTS"]))
    for n, v in defs.items():
        assert getattr(kc, n) == v, n
    ovs = specs()
    payload = pb._pack_overrides(ovs, C, V, WIDE)
    ei, ewv = pb._pack_elem_w(ovs, E, np.float32, 4)
    T = 5
    tape = (np.linspace(0, 1, T), np.arange(T, dtype=np.int32),
            np.ones(T, np.float32))
    parts = [None] * kc.FP_PARTS
    for name, a in (("FP_BW", payload[0]), ("FP_FS", payload[1]),
                    ("FP_LI", payload[2]), ("FP_LF", payload[3]),
                    ("FP_FI", payload[4]), ("FP_FF", payload[5]),
                    ("FP_DI", payload[6]), ("FP_EI", ei), ("FP_EWV", ewv),
                    ("FP_TT", tape[0]), ("FP_TS", tape[1]),
                    ("FP_TV", tape[2])):
        parts[defs[name]] = np.ascontiguousarray(a)
    for absent in ((), (kc.FP_EI, kc.FP_EWV)):
        ps = [None if k in absent else a for k, a in enumerate(parts)]
        off, n = k11.layout(ps)
        buf = np.zeros(n + 64, np.uint8)
        k11.pack(ps, buf, off)
        end = 0
        for k, a in enumerate(ps):
            assert off[k] % defs["FP_ALIGN"] == 0 and off[k] >= end
            if a is None:
                continue
            got = buf[off[k]:off[k] + a.nbytes].view(a.dtype)
            assert np.array_equal(got, a.reshape(-1))
            end = off[k] + a.nbytes
        assert n == -(-end // defs["FP_ALIGN"]) * defs["FP_ALIGN"]
        assert not buf[n:].any()
