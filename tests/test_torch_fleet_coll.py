"""The port's collective fleets against the JAX package's, on the CPU, bit
for bit (tolerance 0): ``Campaign.for_collective`` / ``ScenarioPlan.
for_collective`` fleets (``BatchDrainSim(collective=)``) against the JAX
fleet and against the port's own solo ``DrainSim(collective=)``, in
completions, activations and the Kahan clock pair; a faulted lane; an
admission; a deadlocked lane; the rejections; the plan key; the
counters; and a JAX collective fleet's committed state resumed in the
port.  Sizes: the ring allreduce at 5 ranks and recursive doubling at 6
(its remainder arm), float64, superstep 4.
"""

import numpy as np
import pytest

from simgrid_tpu.collectives import CollectiveSpec as JaxCSpec
from simgrid_tpu.ops import opstats as jax_opstats
from simgrid_tpu.parallel.campaign import Campaign as JaxCampaign
from simgrid_tpu.parallel.campaign import ScenarioPlan as JaxPlan
from simgrid_tpu.parallel.campaign import ScenarioSpec as JaxSpec
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.collectives import CollectiveSpec
from simgrid_tpu_torch.ops import lmm_batch as pb
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.parallel import campaign as pc

K = 4
CASES = {"ring": CollectiveSpec("allreduce", "lr", 5, "ring", 64, bw=1e8),
         "rdb": CollectiveSpec("allreduce", "rdb", 6, "nic", 4096, bw=1e8)}


def jcs(cs):
    return JaxCSpec.from_dict(cs.to_dict())


def jspec(s):
    return JaxSpec.from_dict(s.to_dict())


def sweep(cs):
    """check_determinism's three-lane sweep (plain, bandwidth, sizes and
    one link)."""
    return [pc.ScenarioSpec(seed=0, collective=cs, label="plain"),
            pc.ScenarioSpec(seed=1, bw_scale=0.5, collective=cs,
                            label="bw"),
            pc.ScenarioSpec(seed=2, size_scale=2.0, link_scale={0: 0.25},
                            label="scaled")]


def plans(cs, mode="off"):
    kw = dict(fault_mode=mode, superstep=K, dtype=np.float64)
    return (pc.ScenarioPlan.for_collective(cs, device="cpu", **kw),
            JaxPlan.for_collective(jcs(cs), **kw))


def lanes(sim):
    """Each lane's completions, activations, faults, clock, advances and
    Kahan pair."""
    pairs = (np.asarray(sim._coll_clk) if hasattr(sim, "_coll_clk")
             else [sim.collective_clock_of(b) for b in range(sim.B)])
    return [(r.events, r.collective_events, r.fault_events, r.t,
             r.advances, tuple(float(x) for x in pairs[b]))
            for b, r in enumerate(sim.replicas)]


def solo_lane(res):
    return (res.events, res.collective_events, res.fault_events, res.t,
            res.advances)


def run_pair(cs, specs, mode="off", between=None, width=None,
             tape_slots=0):
    """The same fleet in both packages (``between(sim, plan, specs)``
    after every superstep), with each one's counter deltas."""
    pp, jp = plans(cs, mode)
    out = []
    for plan, sp, stats in ((pp, specs, opstats),
                            (jp, [jspec(s) for s in specs], jax_opstats)):
        with stats.scoped("fleet") as d:
            sim = plan.executor(sp, width=width, tape_slots=tape_slots)
            while sim._alive.any():
                sim.superstep_all()
                if between is not None:
                    between(sim, plan)
        out.append((sim, d))
    (p, pd), (j, jd) = out
    return pp, p, j, pd, jd


@pytest.fixture(scope="module", params=sorted(CASES))
def sweep_pair(request):
    cs = CASES[request.param]
    return (cs,) + run_pair(cs, sweep(cs))


def test_fleet_equals_jax_and_solo(sweep_pair):
    """Every lane equals the JAX fleet's and its solo port drain, by
    bits; every lane fired activations and finished."""
    cs, pp, p, j, _, _ = sweep_pair
    got, want = lanes(p), lanes(j)
    assert got == want
    specs = sweep(cs)
    for b, spec in enumerate(specs):
        solo = pp.solo(spec)
        assert solo.error is None and p.replicas[b].error is None
        assert solo_lane(solo) == got[b][:5]
        assert len(got[b][0]) == pp._dc.n_v and got[b][1]
    # the plain lane is the compiled collective's own tape drain
    ref = pp._dc.make_sim(superstep=K, eps=pp.eps, device="cpu")
    ref.run()
    assert (ref.events, ref.collective_events) == got[0][:2]
    assert tuple(ref._coll_clk.tolist()) == got[0][5]
    assert p.supersteps == j.supersteps and p.pad_events == 0


def test_counters_equal_jax(sweep_pair):
    """``collective_tape_slots`` (n_v per lane at birth) and
    ``collective_tape_fires`` (one per activation) move as JAX's, and so
    do the dispatches."""
    cs, pp, p, j, pd, jd = sweep_pair
    n_v = pp._dc.n_v
    fires = sum(len(r.collective_events) for r in p.replicas)
    for k in ("collective_tape_slots", "collective_tape_fires",
              "dispatches", "batch_dispatches", "fixpoint_rounds"):
        assert pd.get(k, 0) == jd.get(k, 0), k
    assert pd["collective_tape_slots"] == 3 * n_v
    assert pd["collective_tape_fires"] == fires > 0


def test_chunking_equals_one_fleet():
    """``Campaign.for_collective`` in fleets of 2 gives the fleet of 3's
    results, collective events included (``run_batched``)."""
    cs = CASES["ring"]
    camp = pc.Campaign.for_collective(cs, sweep(cs), fault_mode="off",
                                      superstep=K, device="cpu")
    jcamp = JaxCampaign.for_collective(jcs(cs), [jspec(s)
                                                 for s in sweep(cs)],
                                       fault_mode="off", superstep=K,
                                       dtype=np.float64)
    got = camp.run_batched(batch=2)
    want = jcamp.run_batched(batch=3)
    for g, w in zip(got, want):
        assert solo_lane(g) == solo_lane(w)
        assert g.error is None and g.collective_events


def t_end(cs):
    dc = cs.build()
    sim = dc.make_sim(superstep=K, eps=1e-9, device="cpu")
    sim.run()
    return sim.t


def faulted(cs, seed):
    end = t_end(cs)
    return pc.ScenarioSpec(seed=seed, fault_mtbf=2.0 * end,
                           fault_mttr=0.1 * end, fault_horizon=end,
                           collective=cs, label=f"faulted{seed}")


def test_faulted_lane_and_admission_equal_jax_and_solo():
    """A lane under a fault tape (``fault_mode="on"``) beside a plain
    one, and a faulted spec admitted into a dead row after the first
    superstep: every lane equals JAX's and its solo drain, and faults
    fired before the last completion."""
    cs = CASES["rdb"]
    specs = [pc.ScenarioSpec(seed=0, collective=cs), faulted(cs, 7)]
    new = faulted(cs, 11)
    new.bw_scale = 0.75

    def admit(sim, plan):
        if sim.supersteps == 1:
            s = new if isinstance(plan, pc.ScenarioPlan) else jspec(new)
            sim.admit_lane(2, plan.overrides_for(s), plan.tape_for(s))
    pp, p, j, pd, jd = run_pair(cs, specs, mode="on", between=admit,
                                width=3, tape_slots=64)
    got = lanes(p)
    assert got == lanes(j)
    for b, spec in enumerate(specs + [new]):
        assert solo_lane(pp.solo(spec)) == got[b][:5]
    for b in (1, 2):
        fev, ev = got[b][2], got[b][0]
        assert fev and fev[0][0] <= ev[-1][0]
    assert p.admitted == j.admitted == 1
    for k in ("collective_tape_slots", "collective_tape_fires",
              "fault_tape_events", "dispatches"):
        assert pd.get(k, 0) == jd.get(k, 0), k
    with pytest.raises(pb.AdmissionError, match="cannot kill DAG"):
        p.admit_lane(0, pb.ReplicaOverrides(dead_flows=(1,)))


def truncate(state, lane, flow):
    """A committed state whose ``lane`` owes one more predecessor to
    ``flow`` than its schedule has: that lane's DAG is cut."""
    arrays = dict(state["arrays"])
    pred = np.array(arrays["coll_pred"])
    pred[lane, flow] += 1
    arrays["coll_pred"] = pred
    return dict(state, arrays=arrays)


def test_truncated_dag_quarantines_its_lane_as_jax():
    """After one superstep lane 1's predecessor count of the last flow
    is raised by one (the state handed over by ``committed_state``):
    lane 1 ends quarantined as ``collective_deadlock`` with JAX's
    detail, the others finish equal to their solo drains."""
    cs = CASES["ring"]
    pp, jp = plans(cs)
    specs = sweep(cs)
    sims = []
    for plan, sp in ((pp, specs), (jp, [jspec(s) for s in specs])):
        sim = plan.executor(sp)
        sim.superstep_all()
        sim.restore_state(truncate(sim.committed_state(), 1,
                                   pp._dc.n_v - 1))
        before = (opstats if plan is pp else jax_opstats).snapshot()
        sim.run()
        d = (opstats if plan is pp else jax_opstats).diff(before)
        assert d.get("lane_quarantined_collective_deadlock") == 1
        sims.append(sim)
    p, j = sims
    fp, fj = p.replicas[1].fault, j.replicas[1].fault
    assert fp.cause == fj.cause == "collective_deadlock"
    assert fp.detail == fj.detail and fp.lane == fj.lane == 1
    assert fp.superstep == fj.superstep and fp.t == fj.t
    assert p.replicas[1].error == j.replicas[1].error
    for b in (0, 2):
        assert p.replicas[b].fault is None
        assert solo_lane(pp.solo(specs[b])) == lanes(p)[b][:5]
    assert lanes(p) == lanes(j)


def test_fleet_state_from_jax_resumes_equal(sweep_pair):
    """A JAX collective fleet stopped after one superstep hands its
    committed state (``convert.fleet_state``) to a port fleet, which
    finishes equal to the JAX fleet run to its end; the port's own
    snapshot round-trips, and a fleet without a collective refuses it."""
    cs, pp, p, j, _, _ = sweep_pair
    jp = JaxPlan.for_collective(jcs(cs), fault_mode="off", superstep=K,
                                dtype=np.float64)
    jf = jp.executor([jspec(s) for s in sweep(cs)])
    jf.superstep_all()
    st = convert.fleet_state(jf.committed_state())
    q = pp.executor(sweep(cs))
    q.restore_state(st)
    assert q.supersteps == 1 and any(r.collective_events
                                     for r in q.replicas)
    q.run()
    assert lanes(q) == lanes(j)
    r = pp.executor(sweep(cs))
    r.restore_state(q.committed_state())
    assert lanes(r) == lanes(q)
    plain = pc.ScenarioPlan(pp.e_var, pp.e_cnst, pp.e_w, pp.c_bound,
                            pp.sizes, penalty=pp.penalty, fault_mode="off",
                            superstep=K, device="cpu")
    with pytest.raises(ValueError, match="without collective="):
        plain.executor([pc.ScenarioSpec(seed=b)
                        for b in range(3)]).restore_state(st)
    del st["arrays"]["coll_pred"]
    with pytest.raises(ValueError, match="no collective arrays"):
        pp.executor(sweep(cs)).restore_state(st)


def test_rejections_equal_jax():
    """Dead flows on a collective plan, a spec/plan collective mismatch,
    float32 and a wrong-sized schedule are refused as JAX refuses
    them."""
    cs, other = CASES["ring"], CASES["rdb"]
    pp, jp = plans(cs)
    bad_specs = [
        (pc.ScenarioSpec(seed=0, dead_flows=(1,), collective=cs),
         "kills flows"),
        (pc.ScenarioSpec(seed=0, collective=other), "was compiled for")]
    for spec, msg in bad_specs:
        for plan, s in ((pp, spec), (jp, jspec(spec))):
            with pytest.raises(ValueError, match=msg):
                plan.executor([s])
            with pytest.raises(ValueError, match=msg):
                plan.solo(s)
    plain = (pc.ScenarioPlan(pp.e_var, pp.e_cnst, pp.e_w, pp.c_bound,
                             pp.sizes, device="cpu"),
             JaxPlan(pp.e_var, pp.e_cnst, pp.e_w, pp.c_bound, pp.sizes,
                     fault_mode="on"))
    spec = pc.ScenarioSpec(seed=0, collective=cs)
    for plan, s in zip(plain, (spec, jspec(spec))):
        with pytest.raises(ValueError, match="the plan has none"):
            plan.executor([s])
    for cls, c in ((pc.ScenarioPlan, cs), (JaxPlan, jcs(cs))):
        with pytest.raises(ValueError, match="require dtype float64"):
            cls.for_collective(c, dtype=np.float32)
        with pytest.raises(ValueError, match="do not match"):
            cls(pp.e_var, pp.e_cnst, pp.e_w, pp.c_bound[:-1], pp.sizes,
                collective=c)
    # BatchDrainSim's own checks, both packages
    from simgrid_tpu.ops import lmm_batch as jb
    dc = pp._dc
    args = (dc.e_var, dc.e_cnst, dc.e_w, dc.c_bound, dc.sizes)
    for mod, extra in ((pb, dict(device="cpu")), (jb, {})):
        kw = dict(penalty=dc.penalty0, superstep=K, **extra)
        with pytest.raises(ValueError, match="cannot kill DAG"):
            mod.BatchDrainSim(*args, [mod.ReplicaOverrides(
                dead_flows=(0,))], collective=dc.drain_args(), **kw)
        with pytest.raises(ValueError, match="needs dtype=float64"):
            mod.BatchDrainSim(*args, [mod.ReplicaOverrides()],
                              dtype=np.float32,
                              collective=dc.drain_args(), **kw)
        with pytest.raises(ValueError, match="per-flow"):
            mod.BatchDrainSim(*args, [mod.ReplicaOverrides()],
                              collective=(dc.pred0[:-1],)
                              + dc.drain_args()[1:], **kw)


def test_plan_key_equals_jax():
    """A collective plan's topology hash and plan key equal JAX's, and
    differ from the same arrays' plan without the collective."""
    for cs in CASES.values():
        pp, jp = plans(cs)
        assert pp.topology_hash() == jp.topology_hash()
        for width in (1, 3, 32):
            assert pp.plan_key(width) == jp.plan_key(width)
        plain = pc.ScenarioPlan(pp.e_var, pp.e_cnst, pp.e_w, pp.c_bound,
                                pp.sizes, penalty=pp.penalty,
                                fault_mode="off", superstep=K,
                                device="cpu")
        assert plain.topology_hash() != pp.topology_hash()
        spec = pc.ScenarioSpec(seed=4, bw_scale=0.5, collective=cs)
        assert spec.key() == jspec(spec).key()


def test_collective_fleet_workload_row():
    """``workloads/collective_fleet.py``'s mix through ``fleet_run.
    run_fleet_full`` on the CPU: the row's completions, activations and
    fires are its lanes', its dispatches and activation fires the
    counters', and every lane equals its solo drain."""
    from simgrid_tpu_torch.workloads import collective_fleet as cf
    from simgrid_tpu_torch.workloads import fleet_run
    cs = CASES["rdb"]
    ref = cs.build().make_sim(superstep=cf.SUPERSTEP, eps=cf.EPS,
                              device="cpu")
    ref.run()
    specs = cf.fleet_specs(cs, ref.t, 4)
    camp = cf.fleet_campaign(cs, specs, "cpu")
    with opstats.scoped("workload") as d:
        sim, row = fleet_run.run_fleet_full(camp)
    reps = sim.replicas
    assert (row["case"], row["edges"]) == ("rdb-r6", camp.plan._dc.n_edges)
    assert row["completions"] == sum(len(r.events) for r in reps) \
        == 4 * sim.n_v
    assert row["activations"] == row["collective_tape_fires"] \
        == d["collective_tape_fires"] > 0
    assert row["dispatches"] == d["dispatches"]
    assert row["fires"] == [len(r.fault_events) for r in reps]
    assert row["errors"] == [None] * 4 and row["launches"] == {}
    for b, spec in enumerate(specs):
        assert cf.same_lane(reps[b], camp.plan.solo(spec))
    assert cf.same_lane(reps[0], ref)
    with pytest.raises(ValueError, match="multiple of 4"):
        cf.fleet_specs(cs, ref.t, 6)
