"""The port's pipelined drains (``pipeline=D``) against the JAX package,
on the CPU, bit for bit (tolerance 0): ``DrainSim(superstep=K,
pipeline=D)`` and ``BatchDrainSim(pipeline=D)`` (through ``Campaign``)
give the events, fault events, collective events and clocks of
``pipeline=0`` and of the JAX drain, through every discard (a repack, a
budget rescue, the ring-saturation rescue, a tape fire, a lane's death,
an admission between supersteps), and their speculation counters equal
JAX's pipelined run on the same inputs.  The CPU path runs the same
issue, chain, collect, discard and adopt as the card.  Sizes are
``tests/test_drain_pipeline.py``'s: 48 links, 300 flows, K 8, B <= 8.
"""

import numpy as np
import pytest
import torch

from bench import build_arrays
from simgrid_tpu.collectives import CollectiveSpec as JaxCSpec
from simgrid_tpu.ops import opstats as jax_opstats
from simgrid_tpu.ops.lmm_batch import BatchDrainSim as JaxBatch
from simgrid_tpu.ops.lmm_batch import ReplicaOverrides as JaxOverrides
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu.parallel.campaign import Campaign as JaxCampaign
from simgrid_tpu.parallel.campaign import ScenarioSpec as JaxSpec
from simgrid_tpu_torch.collectives import CollectiveSpec
from simgrid_tpu_torch.ops import lmm_batch as pb
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from simgrid_tpu_torch.parallel import campaign as pc
from simgrid_tpu_torch.workloads import pipeline as pl

K = 8
NO_REPACK = 1 << 62
SPEC = ("spec_issued", "spec_committed", "spec_rolled_back")
SPEC_OPS = ("speculations_issued", "speculations_committed",
            "speculations_rolled_back", "fault_replays",
            "collective_replays")


@pytest.fixture(scope="module")
def drain_system():
    rng = np.random.default_rng(29)
    n_c, n_v = 48, 300
    arrays = build_arrays(rng, n_c, n_v, 3, np.float64)
    E = arrays.n_elem
    sizes = rng.choice(np.linspace(1e5, 2e6, 16), n_v)
    return (arrays.e_var[:E], arrays.e_cnst[:E], arrays.e_w[:E],
            arrays.c_bound[:n_c], sizes)


def solo(cls, system, **kw):
    """A drained solo sim of either package, with its counter deltas."""
    stats = opstats if cls is DrainSim else jax_opstats
    dev = {"device": "cpu"} if cls is DrainSim else {}
    with stats.scoped("pipeline-test") as d:
        sim = cls(*system, eps=1e-9, dtype=np.float64, superstep=K, **kw,
                  **dev)
        sim.run()
    return sim, d


def streams(sim):
    return (sim.events, sim.fault_events, sim.collective_events, sim.t,
            sim.advances)


def census(sim, d):
    return ([getattr(sim, k) for k in SPEC],
            [d.get(k, 0) for k in SPEC_OPS])


SOLO = {"plain-d1": (dict(repack_min=NO_REPACK), 1),
        "plain-d2": (dict(repack_min=NO_REPACK), 2),
        "repack-d2": (dict(repack_min=32), 2),
        "budget-d1": (dict(repack_min=NO_REPACK, superstep_rounds=3), 1)}


@pytest.mark.parametrize("case", sorted(SOLO))
def test_solo_depth_equals_depth0_and_jax(drain_system, case):
    """Depths 1 and 2 give depth 0's and JAX's streams by bits, through
    the repack mispredict and the budget rescue, and speculation
    commits; the counters equal JAX's pipelined run."""
    kw, depth = SOLO[case]
    ref, _ = solo(JaxDrainSim, drain_system, pipeline=0, **kw)
    p0, _ = solo(DrainSim, drain_system, pipeline=0, **kw)
    p, pd = solo(DrainSim, drain_system, pipeline=depth, **kw)
    j, jd = solo(JaxDrainSim, drain_system, pipeline=depth, **kw)
    assert streams(p) == streams(p0) == streams(ref)
    assert (p.supersteps, p.repacks) == (j.supersteps, j.repacks)
    assert census(p, pd) == census(j, jd)
    assert p.spec_committed > 0
    if case.startswith(("repack", "budget")):
        assert p.spec_rolled_back > 0
    if case.startswith("repack"):
        assert p.repacks > 0
    # one graph per buffer set: the committed one and D + 1 spares, built
    # again for each set after a repack
    assert p.loop_builds <= p0.loop_builds + (depth + 1) * (1 + p.repacks)


def test_ring_saturation_rescue():
    """The whole drain in one superstep under a starved budget: partial
    batches and rescue advances, pipelined, give the unfused stream."""
    groups, per = 6, 40
    e_var, e_cnst, e_w = [], [], []
    for g in range(groups):
        for j in range(per):
            v = g * per + j
            e_var += [v, v]
            e_cnst += [0, 1 + g]
            e_w += [1.0, 1.0]
    args = (np.array(e_var, np.int32), np.array(e_cnst, np.int32),
            np.array(e_w), np.array([1e6 * groups] + [1e6] * groups),
            np.repeat(1e6 * (1.0 + np.arange(groups)), per))
    ref = JaxDrainSim(*args, eps=1e-9, dtype=np.float64,
                      repack_min=NO_REPACK)
    ref.run()
    kw = dict(superstep_rounds=3, repack_min=NO_REPACK)
    p, pd = solo(DrainSim, args, pipeline=2, **kw)
    j, jd = solo(JaxDrainSim, args, pipeline=2, **kw)
    assert (p.events, p.t) == (ref.events, ref.t)
    assert census(p, pd) == census(j, jd)


def test_pipeline_requires_superstep(drain_system):
    with pytest.raises(ValueError, match="superstep"):
        JaxDrainSim(*drain_system, pipeline=1)
    with pytest.raises(ValueError, match="superstep"):
        DrainSim(*drain_system, pipeline=1, device="cpu")


def test_tape_drain_pipelined_equals_jax(drain_system):
    """A fault tape pipelined: fires end the clean window (replays
    counted as JAX counts them), and every committed speculative
    superstep's base clock, derived on the card, equals by bits the
    clock the host's collect of its predecessor left."""
    base, _ = solo(DrainSim, drain_system, repack_min=NO_REPACK)
    end = base.t
    cb = drain_system[3]
    tape = (np.array([0.2, 0.35, 0.6]) * end, np.array([3, 7, 3], np.int32),
            np.array([cb[3] * 0.1, cb[7] * 0.5, cb[3]]))
    kw = dict(repack_min=NO_REPACK, tape=tape)
    ref, _ = solo(JaxDrainSim, drain_system, **kw)
    j, jd = solo(JaxDrainSim, drain_system, pipeline=2, **kw)
    checked = []
    orig = DrainSim._superstep_collect

    def collect(sim, tok):
        if tok.speculative:
            checked.append((float(tok.t0[0]), sim.t))
        return orig(sim, tok)
    DrainSim._superstep_collect = collect
    try:
        p, pd = solo(DrainSim, drain_system, pipeline=2, **kw)
    finally:
        DrainSim._superstep_collect = orig
    assert streams(p) == streams(ref)
    assert len(p.fault_events) == 3
    assert census(p, pd) == census(j, jd)
    assert pd.get("fault_replays", 0) > 0
    assert checked and all(a == b for a, b in checked)


def test_collective_drain_pipelined_equals_jax():
    """A collective drain pipelined: the DAG carry (predecessor counts,
    activation dates, Kahan pair) chains from set to set; completions,
    activations and the pair equal depth 0's and JAX's."""
    args = ("allreduce", "rdb", 6, "nic", 1 << 20)
    jdc, pdc = JaxCSpec(*args).build(), CollectiveSpec(*args).build()
    ref = jdc.make_sim(superstep=4)
    ref.run()
    out = {}
    for depth in (0, 2):
        with opstats.scoped("pipeline-coll") as d:
            p = pdc.make_sim(superstep=4, pipeline=depth, device="cpu")
            p.run()
        out[depth] = (p, d)
    with jax_opstats.scoped("pipeline-coll") as jd:
        j = jdc.make_sim(superstep=4, pipeline=2)
        j.run()
    p, pd = out[2]
    for q in (p, out[0][0]):
        assert streams(q) == streams(ref)
        assert q._coll_clk.tolist() == np.asarray(ref._coll_clk).tolist()
    assert census(p, pd) == census(j, jd)
    assert p.spec_committed > 0


def fleet_specs(S):
    return [S(seed=s, bw_scale=1.0 + 0.2 * (s % 4),
              size_scale=1.0 + 0.05 * (s % 3),
              dead_flows=(s % 5,) if s % 3 == 0 else ())
            for s in range(8)]


def test_fleet_equals_depth0_jax_and_solo(drain_system):
    """A fleet of 8 pipelined (lanes dying at different supersteps):
    every replica equals JAX's depth 0 (which the port's depth 0 equals,
    ``tests/test_torch_fleet.py``; the admission cases below hold depth
    2 against the port's own depth 0) and replica 3 its solo drain; the
    counters equal JAX's pipelined run."""
    camp = pc.Campaign(*drain_system, fleet_specs(pc.ScenarioSpec),
                       eps=1e-9, dtype=np.float64, superstep=K,
                       device="cpu")
    jcamp = JaxCampaign(*drain_system, fleet_specs(JaxSpec), eps=1e-9,
                        dtype=np.float64, superstep=K)
    ref = jcamp.run_batched(batch=8, pipeline=0)
    got, pd = camp.run_scoped(8, "fleet-d2", pipeline=2)
    _, jd = jcamp.run_scoped(8, "fleet-d2", pipeline=2)
    for g, r in zip(got, ref):
        assert (g.events, g.t, g.advances) == (r.events, r.t, r.advances)
    s3 = camp.run_solo(3)
    assert (got[3].events, got[3].t) == (s3.events, s3.t)
    assert [pd.get(k, 0) for k in SPEC_OPS] \
        == [jd.get(k, 0) for k in SPEC_OPS]
    assert pd["speculations_committed"] > 0
    assert pd["speculations_rolled_back"] > 0


def test_lane_death_rolls_back(drain_system):
    """A replica that finishes early changes the alive mask under the
    superstep in flight: it is discarded (counted as JAX counts it) and
    every replica stays exact."""
    def fleet(cls, R, depth, **dev):
        sim = cls(*drain_system, [R(bw_scale=50.0), R(bw_scale=1.0),
                                  R(bw_scale=0.5)],
                  eps=1e-9, dtype=np.float64, superstep=K, pipeline=depth,
                  **dev)
        sim.run()
        return sim
    ref = fleet(JaxBatch, JaxOverrides, 0)
    got = fleet(pb.BatchDrainSim, pb.ReplicaOverrides, 2, device="cpu")
    j = fleet(JaxBatch, JaxOverrides, 2)
    assert got.spec_rolled_back > 0
    assert [getattr(got, k) for k in SPEC] == [getattr(j, k) for k in SPEC]
    for b in range(3):
        assert (got.replicas[b].events, got.replicas[b].t) \
            == (ref.replicas[b].events, ref.replicas[b].t) \
            == (j.replicas[b].events, j.replicas[b].t)


RESCUE_SUPERSTEPS = 48


@pytest.mark.parametrize("taped", [False, True], ids=["fused", "tape"])
def test_fleet_budget_rescue_pipelined(drain_system, taped):
    """A fleet of 4 under a starved round budget (``superstep_rounds=3``,
    a rescue after nearly every superstep): the budget rescue (the fused
    one, or with tapes the superstep one) runs inside a collect with
    supersteps in flight behind it and discards them; over the first
    ``RESCUE_SUPERSTEPS`` collects (the state at a cut is compared, so
    the test stays short) every replica at depth 2 equals depth 0 and
    JAX's pipelined fleet by bits, and the counters equal JAX's."""
    base, _ = solo(DrainSim, drain_system, repack_min=NO_REPACK)
    cb = drain_system[3]

    def tapes():
        if not taped:
            return None
        return [(np.array([0.02, 0.05]) * base.t * (1 + 0.1 * b),
                 np.array([3, 3], np.int32), np.array([cb[3] * 0.2, cb[3]]))
                if b % 2 == 0 else None for b in range(4)]

    def fleet(cls, R, depth, **dev):
        stats = opstats if cls is pb.BatchDrainSim else jax_opstats
        with stats.scoped("fleet-rescue") as d:
            sim = cls(*drain_system, [R(bw_scale=1.0 + 0.3 * b)
                                      for b in range(4)],
                      eps=1e-9, dtype=np.float64, superstep=K,
                      superstep_rounds=3, pipeline=depth, tapes=tapes(),
                      **dev)
            sim.run(max_supersteps=RESCUE_SUPERSTEPS)
        return sim, d
    ref, _ = fleet(pb.BatchDrainSim, pb.ReplicaOverrides, 0, device="cpu")
    got, pd = fleet(pb.BatchDrainSim, pb.ReplicaOverrides, 2, device="cpu")
    j, jd = fleet(JaxBatch, JaxOverrides, 2)
    assert got.rescues > 8 and got.spec_rolled_back > 8
    assert got._alive.all()         # cut before any lane finished
    assert census(got, pd) == census(j, jd)
    for b in range(4):
        lanes = [(s.replicas[b].events, s.replicas[b].fault_events,
                  s.replicas[b].t, s.replicas[b].advances)
                 for s in (got, ref, j)]
        assert lanes[0] == lanes[1] == lanes[2]
    if taped:
        assert [len(r.fault_events) for r in got.replicas] == [2, 0, 2, 0]


SNAPS = (1, 4)


@pytest.fixture(scope="module")
def admissions(drain_system):
    """A fleet of 3 specs in a row of 4 at depths 0 and 2: after the
    second collect a fresh spec is admitted into the dead row from
    ``between`` (which says so); the committed state is taken after the
    collects ``SNAPS``.  Returns, by depth, the fleet and its snapshots,
    and the admitted spec's solo drain."""
    plan = pc.ScenarioPlan(*drain_system, eps=1e-9, dtype=np.float64,
                           superstep=K, device="cpu")
    specs = fleet_specs(pc.ScenarioSpec)[:3]
    new = pc.ScenarioSpec(seed=9, bw_scale=0.7, size_scale=1.1)
    out = {}
    for depth in (0, 2):
        sim = plan.executor(specs, width=4, pipeline=depth)
        seen, snaps = [0], {}

        def between(s):
            seen[0] += 1
            if seen[0] in SNAPS:
                snaps[seen[0]] = s.committed_state()
            if seen[0] == 2:
                s.admit_lane(3, plan.overrides_for(new))
                return True
            return False
        sim.run(between=between)
        out[depth] = (sim, snaps)
    return out, plan.solo(new)


def test_admission_between_supersteps(admissions):
    """An admission from ``between`` at depth 2 discards the supersteps
    in flight; every lane, the admitted one too (which equals its solo
    drain), equals depth 0's."""
    out, new_solo = admissions
    ref, got = out[0][0], out[2][0]
    assert got.admitted == ref.admitted == 1
    assert got.spec_rolled_back > 0 and got.spec_committed > 0
    for a, b in zip(got.replicas, ref.replicas):
        assert (a.events, a.t, a.advances) == (b.events, b.t, b.advances)
    assert (got.replicas[3].events, got.replicas[3].t) \
        == (new_solo.events, new_solo.t)


@pytest.mark.parametrize("at", SNAPS)
def test_committed_state_holds_no_speculation(admissions, at):
    """``committed_state()`` at a collect boundary, with supersteps in
    flight at depth 2, equals depth 0's at the same boundary."""
    out, _ = admissions
    s0, s2 = out[0][1][at], out[2][1][at]
    a0, a2 = s0["arrays"], s2["arrays"]
    assert sorted(a0) == sorted(a2)
    for name in a0:
        assert np.array_equal(a0[name], a2[name]), name
    assert s0["errors"] == s2["errors"]


def test_solo_wave_counts_equal_recorded():
    """``bench.py``'s solo wave (``workloads/pipeline.py``): advances,
    supersteps, fetches and speculations at depths 0-2 are the recorded
    rows'; on the CPU no fetch blocks."""
    out = {}
    for depth in pl.DEPTHS:
        sim, row = pl.run_solo(depth, "cpu", host_work_us=0.0)
        assert pl.recorded_mismatch(row) == []
        assert row["blocking_fetches"] == 0
        out[depth] = (sim.events, sim.t)
    assert out[1] == out[0] == out[2]


def test_fleet_unported_options_still_raise():
    """Only ``pipeline`` left the fleet's refusals."""
    arrays = pl.build_wave_arrays(**pl.STAGE)
    ov = [pb.ReplicaOverrides()]
    for kw, item in ((dict(mesh=2), "queue A item 9"),
                     (dict(plan=object()), "queue A item 8"),
                     (dict(watchdog=object()), "queue A item 8")):
        with pytest.raises(NotImplementedError, match=item):
            pb.BatchDrainSim(*arrays, ov, device="cpu", pipeline=2, **kw)


def test_discard_leaves_committed_state_untouched(drain_system):
    """Two speculative supersteps in flight on their own sets, then
    discarded: the committed flow state is the head superstep's, and the
    drain goes on to depth 0's result."""
    ref, _ = solo(DrainSim, drain_system, repack_min=NO_REPACK)
    sim = DrainSim(*drain_system, eps=1e-9, dtype=np.float64, superstep=K,
                   repack_min=NO_REPACK, pipeline=2, device="cpu")
    head = sim._superstep_issue()
    sim._carries.inflight.append(head)
    sim._carries.inflight.append(sim._superstep_issue(prev=head))
    sim._carries.inflight.append(sim._superstep_issue(prev=sim._carries.inflight[-1]))
    sim._carries.inflight.popleft()
    sim._superstep_collect(head)
    committed = [t.clone() for t in (sim._pen, sim._rem)]
    assert all(tok.carry.pen is not sim._pen for tok in sim._carries.inflight)
    sim._carries.discard(sim)
    for a, b in zip(committed, (sim._pen, sim._rem)):
        assert torch.equal(a, b)
    sim.run()
    assert streams(sim) == streams(ref)
