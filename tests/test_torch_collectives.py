"""The port's collective schedule tapes against the JAX package's, on the
CPU, bit for bit (tolerance 0): the compiled ``DeviceCollective`` arrays
of every generator, ``CollectiveSpec``'s key and JSON round trip, the
tape drain (``DrainSim(collective=...)``) and the host maestro
(completions, activations, the carried Kahan pair, dispatches) at
supersteps 1 and 8, a fault tape composed with a collective, and the
deadlock and validation errors.
"""

import numpy as np
import pytest

from simgrid_tpu.collectives import CollectiveSpec as JaxSpec
from simgrid_tpu.collectives import HostMaestro as JaxMaestro
from simgrid_tpu.collectives.schedule import GENERATORS
from simgrid_tpu.ops import opstats as jax_opstats
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.collectives import CollectiveSpec, HostMaestro
from simgrid_tpu_torch.collectives import schedule as port_schedule
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.ops.lmm_drain import DrainSim

DC_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "sizes", "penalty0",
             "pred0", "ready0", "edge_src", "edge_dst", "exec_cost")


def test_generator_registry_equals_jax():
    assert sorted(port_schedule.GENERATORS) == sorted(GENERATORS)
    assert all(port_schedule.GENERATORS[k][1] == GENERATORS[k][1]
               for k in GENERATORS)


@pytest.mark.parametrize("op,algo", sorted(GENERATORS))
def test_device_collective_equals_jax(op, algo):
    """Every generator at a power-of-two and an odd rank count, on each
    topology flavor: the same records, edges and platform arrays."""
    payload = 96 if algo == "lr" else 4096.0
    for ranks, topo in ((8, "nic"), (5, "star"), (6, "ring")):
        kw = dict(op=op, algo=algo, ranks=ranks, topo=topo,
                  payload=payload, bw=1e8)
        j, p = JaxSpec(**kw), CollectiveSpec(**kw)
        assert p.key() == j.key() and p.to_json() == j.to_json()
        assert CollectiveSpec.from_json(p.to_json()).key() == p.key()
        jdc, pdc = j.build(), p.build()
        assert (pdc.n_v, pdc.n_c, pdc.n_edges, pdc.key()) \
            == (jdc.n_v, jdc.n_c, jdc.n_edges, jdc.key())
        assert pdc.schedule.sequence() == jdc.schedule.sequence()
        for f in DC_FIELDS:
            a, b = getattr(jdc, f), getattr(pdc, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for x, y in zip(jdc.drain_args(), pdc.drain_args()):
            np.testing.assert_array_equal(x, y)


def test_spec_validation_matches_jax():
    for bad in (dict(op="allreduce", algo="ring"), dict(topo="torus"),
                dict(ranks=1)):
        for cls in (JaxSpec, CollectiveSpec):
            with pytest.raises(ValueError):
                cls(**bad)


def tape_run(dc, superstep, port, tape=None):
    if port:
        s = dc.make_sim(superstep=superstep, tape=tape, device="cpu")
    else:
        s = dc.make_sim(superstep=superstep, tape=tape)
    s.run()
    clk = tuple(float(x) for x in np.asarray(
        s._coll_clk.tolist() if port else s._coll_clk))
    return s, clk


def drains(s):
    return (s.events, s.collective_events, s.fault_events)


CASES = {"rdb6": ("allreduce", "rdb", 6, "nic", 1 << 20),
         "lr8": ("allreduce", "lr", 8, "nic", 1 << 12)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tape_and_maestro_equal_jax(case):
    """The tape drain at supersteps 1 and 8 and the host maestro, port
    against JAX: the same completions, activations and Kahan pair, bit
    for bit; the port's tape drain equals its own maestro at every
    grouping (the clock pair is carried across supersteps)."""
    op, algo, ranks, topo, payload = CASES[case]
    jdc = JaxSpec(op, algo, ranks, topo, payload).build()
    pdc = CollectiveSpec(op, algo, ranks, topo, payload).build()
    jm = JaxMaestro(jdc)
    jb = jax_opstats.snapshot()
    jm.run()
    jd = jax_opstats.diff(jb)
    pm = HostMaestro(pdc, device="cpu")
    pb = opstats.snapshot()
    pm.run()
    pd = opstats.diff(pb)
    assert drains(pm) == drains(jm) and pm.clock == jm.clock
    assert (pm.dispatches, pm.fetches, pm.advances) \
        == (jm.dispatches, jm.fetches, jm.advances)
    assert pd["dispatches"] == jd["dispatches"] == pm.dispatches
    for k in (1, 8):
        j, jclk = tape_run(jdc, k, port=False)
        p, pclk = tape_run(pdc, k, port=True)
        assert drains(p) == drains(j) and pclk == jclk
        assert (p.advances, p.supersteps, p.t) \
            == (j.advances, j.supersteps, j.t)
        assert drains(p) == drains(pm) and pclk == pm.clock
        assert len(p.collective_events) == int(np.count_nonzero(
            pdc.penalty0 == 0))


def test_collective_counters_equal_jax():
    jdc = JaxSpec("allreduce", "rdb", 6).build()
    pdc = convert.collective_from_jax(jdc)
    jb, pb = jax_opstats.snapshot(), opstats.snapshot()
    tape_run(jdc, 8, port=False)
    tape_run(pdc, 8, port=True)
    jd, pd = jax_opstats.diff(jb), opstats.diff(pb)
    for k in ("collective_tape_slots", "collective_tape_fires",
              "dispatches"):
        assert pd[k] == jd[k], k
    assert pd["collective_tape_slots"] == pdc.n_v


def test_fault_tape_composed_with_collective():
    """A link flip mid-collective (rank 0's uplink down to 2% of its
    bandwidth at 0.7x the mid date, restored at 1.3x): the tape drain
    equals the maestro run under the same tape, port and JAX, and the
    flip moves the events."""
    bw = 1e9
    kw = ("allreduce", "rdb", 8, "nic", 1 << 20)
    jdc, pdc = JaxSpec(*kw, bw=bw).build(), CollectiveSpec(*kw, bw=bw).build()
    base, _ = tape_run(pdc, 4, port=True)
    mid = base.events[len(base.events) // 2][0]
    ft = (np.asarray([mid * 0.7, mid * 1.3]), np.asarray([0, 0], np.int32),
          np.asarray([bw * 0.02, bw]))
    p, pclk = tape_run(pdc, 4, port=True, tape=ft)
    j, jclk = tape_run(jdc, 4, port=False, tape=ft)
    pm = HostMaestro(pdc, tape=ft, device="cpu")
    pm.run()
    jm = JaxMaestro(jdc, tape=ft)
    jm.run()
    assert drains(p) == drains(j) == drains(pm) == drains(jm)
    assert pclk == jclk == pm.clock == jm.clock
    assert len(p.fault_events) == 2 and p.events != base.events


def test_deadlock_raises_as_jax():
    """A 2-flow DAG whose second flow waits on a predecessor that does
    not exist (pred count 2, one edge): after flow 0 completes nothing
    is live and nothing is pending."""
    pred, ready = np.array([0, 2], np.int32), np.array([np.inf, np.inf])
    es, ed, ex = np.array([0], np.int32), np.array([1], np.int32), np.zeros(2)
    args = (np.array([0, 1], np.int32), np.array([0, 1], np.int32),
            np.ones(2), np.array([1e6, 1e6]), np.array([1e6, 1e6]))
    for cls, extra in ((JaxDrainSim, {}), (DrainSim, dict(device="cpu"))):
        sim = cls(*args, dtype=np.float64, superstep=4,
                  penalty=np.array([1.0, 0.0]),
                  collective=(pred, ready, es, ed, ex), **extra)
        with pytest.raises(RuntimeError, match="deadlocked: 1/2"):
            sim.run()
        assert sim.events == [(1.0, 0)]


def test_collective_validation_matches_jax():
    pdc = CollectiveSpec("allreduce", "rdb", 4).build()
    good = pdc.drain_args()
    base = (pdc.e_var, pdc.e_cnst, pdc.e_w, pdc.c_bound, pdc.sizes)
    cases = [
        (dict(superstep=4, dtype=np.float32), good, "float64"),
        (dict(dtype=np.float64), good, "superstep"),
        (dict(superstep=4, dtype=np.float64),
         (good[0][:-1],) + good[1:], "per-flow"),
        (dict(superstep=4, dtype=np.float64),
         good[:2] + (good[2][:-1],) + good[3:], "edge arrays"),
    ]
    for kw, coll, msg in cases:
        for cls, extra in ((JaxDrainSim, {}), (DrainSim, dict(device="cpu"))):
            with pytest.raises(ValueError, match=msg):
                cls(*base, penalty=pdc.penalty0, collective=coll, **kw,
                    **extra)
    # the port's K10 indexes by the edges as given: it checks them (the
    # JAX scatter drops or clamps what is out of range)
    n_v = pdc.n_v
    for es, ed in ((good[2] + n_v, good[3]), (good[2], good[3] + n_v + 1),
                   (good[2] - n_v, good[3])):
        with pytest.raises(ValueError, match="edge out of range"):
            DrainSim(*base, penalty=pdc.penalty0, superstep=4,
                     dtype=np.float64, device="cpu",
                     collective=good[:2] + (es, ed, good[4]))
