"""The port's scenario fleets against the JAX package's, on the CPU, bit
for bit (tolerance 0): ``BatchDrainSim`` through ``ScenarioPlan`` and
``Campaign`` (events, fault events, clocks, counters), every replica
against its solo ``DrainSim``, chunking, the alive mask, K11's
materialisation against ``derive_replica_arrays``, ``solve_arrays_batch``
in every arm, tape fleets with reserved slots, admission, quarantine,
and a JAX fleet's committed state resumed in the port.  The shape is
``bench.py``'s fault stage cut to 32 constraints x 96 flows, 8
replicas, superstep 4.
"""

import numpy as np
import pytest
import torch

from simgrid_tpu.ops import lmm_batch as jb
from simgrid_tpu.ops import opstats as jax_opstats
from simgrid_tpu.parallel.campaign import ScenarioPlan as JaxPlan
from simgrid_tpu.parallel.campaign import ScenarioSpec as JaxSpec
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.ops import lmm_batch as pb
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.parallel import campaign as pc
from simgrid_tpu_torch.workloads import fleet_run

STAGE = dict(n_c=32, n_v=96, deg=3, seed=42)
B = 8
K = 4
COUNTS = ("dispatches", "batch_dispatches", "fixpoint_rounds",
          "fault_tape_slots", "fault_tape_events", "uploaded_bytes_full",
          "uploaded_bytes_delta", "batch_replicas")


def jax_spec(s):
    return JaxSpec.from_dict(s.to_dict())


def plans(dtype=np.float64, mode="on", system=None):
    arrays = system or fleet_run.stage_system(**STAGE)
    kw = dict(eps=1e-9, dtype=dtype, superstep=K, fault_mode=mode)
    return (pc.ScenarioPlan(*arrays, device="cpu", **kw),
            JaxPlan(*arrays, **kw))


def assert_replica(p, j):
    assert p.events == j.events
    assert p.t == j.t
    assert p.fault_events == j.fault_events
    assert p.advances == j.advances
    assert (p.error is None) == (j.error is None)


def drain_pair(specs, dtype=np.float64, tape_slots=0):
    """The same fleet in both packages, with each one's counter deltas."""
    pp, jp = plans(dtype)
    with opstats.scoped("p") as ps:
        p = pp.executor(specs, tape_slots=tape_slots)
        p.run()
    with jax_opstats.scoped("j") as js:
        j = jp.executor([jax_spec(s) for s in specs], tape_slots=tape_slots)
        j.run()
    return pp, p, j, ps, js


@pytest.fixture(scope="module")
def fleet64():
    return drain_pair(fleet_run.sweep_specs(B), tape_slots=64)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fleet_equals_jax_and_solo(fleet64, dtype):
    """Every replica equals the JAX fleet's (a tape fleet with reserved
    slots in f64, fires included) and its solo port drain (in f32 two
    of them: a faulted replica with a dead flow and a sweep one), and
    the counters are JAX's."""
    if dtype == "f64":
        pp, p, j, ps, js = fleet64
    else:
        pp, p, j, ps, js = drain_pair(fleet_run.sweep_specs(B), np.float32)
    specs = fleet_run.sweep_specs(B)
    for b in range(B):
        assert_replica(p.replicas[b], j.replicas[b])
    assert sum(len(r.fault_events) for r in p.replicas) > 10
    assert p.supersteps == j.supersteps and p.rescues == j.rescues
    for k in COUNTS:
        assert ps.get(k, 0) == js.get(k, 0), k
    for b in (range(B) if dtype == "f64" else (0, 3)):
        assert_replica(pp.solo(specs[b]), p.replicas[b])
    assert p.pad_events == 0


def test_chunking_is_invisible(fleet64):
    """Fleets of 3 give every replica the events of the fleet of 8 (and
    the fleet without reserved tape slots those of the fleet with)."""
    pp, p, *_ = fleet64
    camp = pc.Campaign(*fleet_run.stage_system(**STAGE),
                       fleet_run.sweep_specs(B), eps=1e-9, superstep=K,
                       device="cpu")
    res = camp.run_batched(batch=3)
    for b in range(B):
        assert_replica(res[b], p.replicas[b])


def test_alive_mask_freezes_finished_replicas():
    """A replica that finished keeps its rows bit for bit while the
    others drain on, and logs no event."""
    pp, _ = plans(mode="off")
    specs = [pc.ScenarioSpec(seed=0, dead_flows=range(80)),
             pc.ScenarioSpec(seed=1, size_scale=3.0)]
    sim = pp.executor(specs)
    frozen = None
    while sim._alive.any():
        sim.superstep_all()
        if not sim._alive[0] and frozen is None:
            frozen = [t[0].clone() for t in (sim._pen, sim._rem,
                                             sim.sys.c_bound, sim._thresh)]
            n_ev = len(sim.replicas[0].events)
    assert frozen is not None and sim.replicas[1].advances > \
        sim.replicas[0].advances
    for a, t in zip(frozen, (sim._pen, sim._rem, sim.sys.c_bound,
                             sim._thresh)):
        assert torch.equal(a, t[0])
    assert len(sim.replicas[0].events) == n_ev and sim.pad_events == 0


@pytest.mark.parametrize("dtype,mode", [(np.float64, "rel"),
                                        (np.float32, "abs")])
def test_materialization_equals_derive(dtype, mode):
    """K11's birth and admission rows equal ``derive_replica_arrays``
    and ``derive_replica_ew`` (cast to the dtype), pad slots dropped."""
    e_var, e_cnst, e_w, c_bound, sizes = fleet_run.stage_system(**STAGE)
    rng = np.random.default_rng(3)
    rem = sizes * rng.uniform(0.2, 1.0, len(sizes))
    pen = rng.uniform(0.5, 2.0, len(sizes))
    ovs = [pb.ReplicaOverrides(1.3, 0.7, {3: 0.5, 9: 0.25}, {5: 2.0},
                               (1, 7), {4: 0.75, 10: 2.5}),
           pb.ReplicaOverrides(0.9, 1.1, dead_flows=(95,)),
           pb.ReplicaOverrides(elem_w={0: 0.125})]
    sim = pb.BatchDrainSim(e_var, e_cnst, e_w, c_bound, sizes, ovs,
                           dtype=dtype, done_mode=mode, superstep=K,
                           device="cpu", penalty=pen, remains=rem,
                           start_dead=(1,))

    def check(b, ov):
        cb, sz, rm, pn = pb.derive_replica_arrays(c_bound, sizes, rem, pen,
                                                  ov)
        th = 1e-4 * sz if mode == "rel" else np.full(len(sz), 1e-4)
        for t, want in ((sim.sys.c_bound, cb), (sim._pen, pn),
                        (sim._rem, rm), (sim._thresh, th)):
            assert np.array_equal(t[b].numpy(), want.astype(dtype))
        ew = pb.derive_replica_ew(np.pad(e_w, (0, -len(e_w) % 8)), ov,
                                  dtype)
        assert np.array_equal(sim.sys.e_w[b].numpy(), ew)
    for b, ov in enumerate(ovs):
        check(b, ov)
    new = pb.ReplicaOverrides(1.7, 1.2, {31: 3.0}, {0: 0.5, 95: 4.0},
                              (2, 3, 4), {11: 9.0})
    sim.admit_lane(1, new)
    check(1, new)
    check(0, ovs[0])


def _solve_case(case):
    rng = np.random.default_rng(7)
    n_c, n_v, deg, nb = 24, 64, 3, 4
    E = n_v * deg
    e_var = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst = rng.integers(0, n_c, E).astype(np.int32)
    e_w = rng.uniform(0.5, 1.5, E)
    cb = rng.uniform(1.0, 10.0, (nb, n_c))
    pen = np.ones((nb, n_v))
    pen[1, :5] = 0.0
    pen[2] = rng.uniform(0.5, 2.0, n_v)
    vb = np.full((nb, n_v), -1.0)
    fat = np.zeros(n_c, bool)
    kw = {}
    if case == "batch_w":
        e_w = e_w * rng.uniform(0.5, 1.5, (nb, E))
        e_w[3, ::7] = 0.0
    if case in ("bounds_fatpipe", "global"):
        vb = np.where(rng.random((nb, n_v)) < 0.5,
                      rng.uniform(0.01, 0.2, (nb, n_v)), -1.0)
        fat[rng.choice(n_c, 5, replace=False)] = True
    if case == "global":
        kw["parallel_rounds"] = False
    return (e_var, e_cnst, e_w, cb, fat, pen, vb, 1e-9), kw


@pytest.mark.parametrize("case", ["shared", "batch_w", "bounds_fatpipe",
                                  "global"])
def test_solve_arrays_batch_equals_jax(case):
    args, kw = _solve_case(case)
    want = jb.solve_arrays_batch(*args, **kw)
    got = pb.solve_arrays_batch(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert np.all(np.asarray(got[3]) > 0)


@pytest.mark.parametrize("kind", ["faulted", "sweep_elem_w"])
def test_admit_lane_equals_solo_and_jax(kind):
    """Two supersteps into a fleet with a dead row, a new spec is
    admitted there; it finishes equal to its solo drain, and the fleet
    to the same sequence in JAX."""
    specs = fleet_run.sweep_specs(3)
    new = (pc.ScenarioSpec(seed=5, bw_scale=1.2, fault_mtbf=400.0,
                           fault_mttr=50.0, fault_horizon=600.0)
           if kind == "faulted" else
           pc.ScenarioSpec(seed=6, size_scale=0.8, elem_w={4: 0.5, 20: 2.0}))
    pp, jp = plans()
    sims = []
    for plan, sp in ((pp, specs), (jp, [jax_spec(s) for s in specs])):
        sim = plan.executor(sp, width=4, tape_slots=64, batch_w=True)
        for _ in range(2):
            sim.superstep_all()
        s_new = new if plan is pp else jax_spec(new)
        sim.admit_lane(3, plan.overrides_for(s_new), plan.tape_for(s_new))
        sim.run()
        sims.append(sim)
    p, j = sims
    for b in range(4):
        assert_replica(p.replicas[b], j.replicas[b])
    assert_replica(pp.solo(new), p.replicas[3])
    if kind == "faulted":
        assert p.replicas[3].fault_events
    with pytest.raises(pb.AdmissionError, match="out of range"):
        p.admit_lane(4, pb.ReplicaOverrides())


def test_nan_poisoned_replica_quarantines_alone():
    pp, _ = plans()
    poison = pc.ScenarioSpec(seed=9, size_scale=float("nan"))
    clean = [pc.ScenarioSpec(seed=s, bw_scale=1.0 + 0.1 * s)
             for s in range(2)]
    before = opstats.snapshot()
    sim = pp.executor([poison] + clean)
    sim.run()
    assert opstats.diff(before).get("lane_quarantined_nan_solve", 0) == 1
    rep = sim.replicas[0]
    assert rep.fault is not None and rep.fault.cause == "nan_solve"
    assert rep.error and not rep.events
    for b, spec in enumerate(clean, 1):
        assert sim.replicas[b].fault is None
        assert_replica(pp.solo(spec), sim.replicas[b])


def test_fleet_state_from_jax_resumes_equal():
    """A JAX fleet (tapes, per-replica weights) stopped after two
    supersteps hands its committed state to a port fleet, which
    finishes equal to the JAX fleet run to its end."""
    specs = fleet_run.sweep_specs(4)
    specs[2] = pc.ScenarioSpec(seed=2, elem_w={1: 0.5, 30: 1.75})
    pp, jp = plans()
    js = [jax_spec(s) for s in specs]
    ref = jp.executor(js)
    ref.run()
    j = jp.executor(js)
    for _ in range(2):
        j.superstep_all()
    p = pp.executor(specs)
    p.restore_state(convert.fleet_state(j.committed_state()))
    assert p.supersteps == 2
    p.run()
    for b in range(4):
        assert_replica(p.replicas[b], ref.replicas[b])
    # and the port's own snapshot round-trips
    q = pp.executor(specs)
    q.restore_state(p.committed_state())
    assert [r.events for r in q.replicas] == [r.events for r in p.replicas]


def test_spec_keys_and_json_equal_jax():
    specs = fleet_run.sweep_specs(6) + [
        pc.ScenarioSpec(seed=3, link_scale={7: 0.5, 2: 0.25},
                        flow_scale={1: 2.0}, elem_w={4: 1.5},
                        label="x")]
    for s in specs:
        j = jax_spec(s)
        assert s.key() == j.key() and s.to_json() == j.to_json()
        back = pc.ScenarioSpec.from_json(s.to_json())
        assert back.key() == s.key() and back.label == s.label
    pp, jp = plans()
    assert pp.topology_hash() == jp.topology_hash()
    for s in specs:
        jt, pt = jp.tape_for(jax_spec(s)), pp.tape_for(s)
        assert (jt is None) == (pt is None)
        if pt is not None:
            assert all(np.array_equal(a, b) for a, b in zip(pt, jt))
        assert pp.tape_len(s) == jp.tape_len(jax_spec(s))


def test_unported_options_raise():
    arrays = fleet_run.stage_system(**STAGE)
    ov = [pb.ReplicaOverrides()]
    for kw, item in ((dict(mesh=2), "queue A item 9"),
                     (dict(plan=object()), "queue A item 8"),
                     (dict(watchdog=object()), "queue A item 8")):
        with pytest.raises(NotImplementedError, match=item):
            pb.BatchDrainSim(*arrays, ov, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        pb.solve_arrays_batch(*_solve_case("shared")[0], device="cpu",
                              mesh=2)

    class NotADrain:
        def capture_drain_scenario(self):
            return None

    # the engine capture is ported: it refuses a phase that is not a
    # pure drain, as JAX's does
    with pytest.raises(RuntimeError, match="not a pure drain"):
        pc.Campaign.from_engine(NotADrain(), [])
