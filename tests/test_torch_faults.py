"""The port's fault campaigns and fault-tape drains against the JAX
package's, on the CPU, bit for bit (tolerance 0): RngStream draws,
``FaultCampaign``'s schedule and tape, ``fault_drain.tape_for`` against
``ScenarioPlan.tape_for``, and ``DrainSim(tape=...)``'s events,
``fault_events``, clock and counters in every superstep grouping, with
and without rate bounds, in float64 and float32, across a repack.
"""

import numpy as np
import pytest

from simgrid_tpu.faults import FaultCampaign as JaxCampaign
from simgrid_tpu.ops import opstats as jax_opstats
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu.parallel.campaign import ScenarioPlan, ScenarioSpec
from simgrid_tpu.utils import rngstream as jax_rng
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.faults import FaultCampaign
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from simgrid_tpu_torch.utils import rngstream
from simgrid_tpu_torch.workloads import dragonfly, fault_drain

# ---------------------------------------------------------------------------
# RngStream and FaultCampaign
# ---------------------------------------------------------------------------


def test_rngstream_draws_equal_jax():
    for seed in (0, 1, 42, 2**40 + 3):
        a = jax_rng.seeded_stream(seed)
        b = rngstream.seeded_stream(seed)
        for _ in range(3):
            assert [a.rand_u01() for _ in range(50)] \
                == [b.rand_u01() for _ in range(50)]
            assert [a.rand_int(-5, 9) for _ in range(20)] \
                == [b.rand_int(-5, 9) for _ in range(20)]
            a.reset_next_substream()
            b.reset_next_substream()
        a.reset_start_stream()
        b.reset_start_stream()
        assert a.rand_u01() == b.rand_u01()


def _campaign(cls, dist, seed=11):
    fc = cls(seed=seed, horizon=80.0)
    shape = 1.7 if dist == "weibull" else 1.0
    for i in range(5):
        fc.add_link(f"link{i}", mtbf=6.0 + i, mttr=1.5 + 0.25 * i,
                    dist=dist, shape=shape)
    fc.add_host("host-b", mtbf=9.0, mttr=2.0, dist=dist, shape=shape)
    fc.add_host("host-a", mtbf=4.0, mttr=0.5, dist=dist, shape=shape)
    return fc


@pytest.mark.parametrize("dist", ["exponential", "weibull", "fixed"])
def test_campaign_equals_jax(dist):
    j, p = _campaign(JaxCampaign, dist), _campaign(FaultCampaign, dist)
    assert p.generate() == j.generate()
    assert sum(len(v) for v in p.generate().values()) > 20
    for floor in (0.05, 0.5, 1.0):
        assert p.compile_tape(floor) == j.compile_tape(floor)
        assert p.tape_len(floor) == j.tape_len(floor) \
            == len(p.compile_tape(floor))
    assert p.mean_availability() == j.mean_availability()
    assert p.mean_availability(33.0) == j.mean_availability(33.0)
    for off in (0, 1, 7):
        assert p.fork(off).compile_tape(0.1) == j.fork(off).compile_tape(0.1)
    if dist != "fixed":          # fixed delays draw nothing
        assert p.fork(1).compile_tape(0.1) != p.compile_tape(0.1)


def test_campaign_bad_arguments_raise_as_jax():
    for cls in (JaxCampaign, FaultCampaign):
        fc = _campaign(cls, "exponential")
        for floor in (0.0, -0.5, 1.5):
            with pytest.raises(ValueError, match="floor"):
                fc.compile_tape(floor=floor)
            with pytest.raises(ValueError, match="floor"):
                fc.tape_len(floor=floor)
        with pytest.raises(ValueError, match="distribution"):
            fc.add_link("x", 1.0, 1.0, dist="gamma")
        with pytest.raises(ValueError, match="MTBF"):
            fc.add_link("x", 0.0, 1.0)
        with pytest.raises(ValueError, match="horizon"):
            cls(horizon=0.0)


def test_tape_for_equals_scenario_plan():
    sys_ = dragonfly.build_system(200, seed=3)
    names = dragonfly.link_names(sys_)
    plan = ScenarioPlan(sys_.e_var, sys_.e_cnst, sys_.e_w, sys_.c_bound,
                        sys_.sizes, link_names=names, fault_mode="on")
    for seed, dist in ((7, "exponential"), (8, "weibull")):
        spec = ScenarioSpec(seed=seed, fault_mtbf=0.5, fault_mttr=0.01,
                            fault_horizon=0.2, fault_dist=dist,
                            fault_shape=1.5)
        want = plan.tape_for(spec)
        got = fault_drain.tape_for(sys_.e_cnst, sys_.e_w, sys_.c_bound,
                                   seed=seed, horizon=0.2, mtbf=0.5,
                                   mttr=0.01, dist=dist, shape=1.5,
                                   link_names=names)
        assert len(want[0]) > 10
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert all(np.array_equal(a, b)
                   for a, b in zip(convert.tape_from_jax(want), got))


# ---------------------------------------------------------------------------
# DrainSim(tape=...)
# ---------------------------------------------------------------------------

HAND_TAPE = (np.array([5.0, 8.0, 13.0, 17.0]),
             np.array([0, 0, 1, 1], np.int32),
             np.array([5e5, 1e6, 5e5, 1e6]))


def hand_sim(cls, tape, superstep=1, **kw):
    """Two independent flows, one per constraint, f64: rate == bound."""
    if cls is DrainSim:
        kw.setdefault("device", "cpu")
    return cls(np.array([0, 1], np.int32), np.array([0, 1], np.int32),
               np.ones(2), np.array([1e6, 1e6]), np.array([8e6, 1.4e7]),
               eps=1e-9, dtype=np.float64, superstep=superstep, tape=tape,
               **kw)


@pytest.mark.parametrize("superstep", [1, 2])
def test_hand_tape_fires_at_exact_dates(superstep):
    p = hand_sim(DrainSim, HAND_TAPE, superstep)
    p.run()
    # flow 0: 5 s at 1e6 + 3 s at 5e5 + 1.5 s at 1e6 -> 9.5; flow 1:
    # 13 s at 1e6 + 2 s at 5e5 -> 15.0 (the repair at 17 never fires)
    assert p.events == [(9.5, 0), (15.0, 1)] and p.t == 15.0
    assert p.fault_events == [(5.0, 0), (8.0, 0), (13.0, 1)]
    j = hand_sim(JaxDrainSim, HAND_TAPE, superstep)
    j.run()
    assert (p.events, p.t, p.fault_events, p.advances, p.supersteps) \
        == (j.events, j.t, j.fault_events, j.advances, j.supersteps)
    assert p.sys.c_bound.tolist() == [1e6, 5e5]


def test_tape_counters_equal_jax():
    jb, pb = jax_opstats.snapshot(), opstats.snapshot()
    j = hand_sim(JaxDrainSim, HAND_TAPE)
    j.run()
    p = hand_sim(DrainSim, HAND_TAPE)
    p.run()
    jd, pd = jax_opstats.diff(jb), opstats.diff(pb)
    for k in ("fault_tape_slots", "fault_tape_events"):
        assert pd[k] == jd[k]
    assert (pd["fault_tape_slots"], pd["fault_tape_events"]) == (4, 3)
    assert p._tpos_host == j._tpos_host == 3


def test_tape_validation_matches_jax():
    cases = [
        ((np.array([1.0]), np.array([7], np.int32), np.array([5e5])),
         1, "slot out of range"),
        ((np.array([8.0, 5.0]), np.array([0, 0], np.int32),
          np.array([5e5, 1e6])), 1, "time-sorted"),
        ((np.array([8.0, 9.0]), np.array([0], np.int32),
          np.array([5e5, 1e6])), 1, "equal length"),
        (HAND_TAPE, 0, "superstep"),
    ]
    for tape, k, msg in cases:
        for cls in (JaxDrainSim, DrainSim):
            with pytest.raises(ValueError, match=msg):
                hand_sim(cls, tape, superstep=k)


def campaign_system(flows):
    """A dragonfly drain of ``flows`` seeded flows and a seeded campaign
    tape over its links that fires a few dozen times before it ends."""
    sys_ = dragonfly.build_system(flows, seed=5)
    tape = fault_drain.tape_for(sys_.e_cnst, sys_.e_w, sys_.c_bound,
                                seed=7, horizon=0.1, mtbf=2.0, mttr=0.003,
                                link_names=dragonfly.link_names(sys_))
    return sys_, tape


@pytest.fixture(scope="module")
def faulted():
    return campaign_system(200)


def run_pair(sys_, tape, dtype, superstep, bounds=False, **kw):
    dtype = np.dtype(dtype)
    if bounds:
        # per-flow rate caps, about half of them binding
        rng = np.random.default_rng(4)
        kw["v_bound"] = rng.uniform(2e9, 2e10, len(sys_.sizes)).astype(dtype)
    out = []
    for cls in (JaxDrainSim, DrainSim):
        extra = dict(device="cpu") if cls is DrainSim else {}
        s = cls(sys_.e_var, sys_.e_cnst, sys_.e_w.astype(dtype),
                sys_.c_bound.astype(dtype), sys_.sizes, eps=1e-5,
                dtype=dtype, superstep=superstep, tape=tape, **kw, **extra)
        s.run()
        out.append(s)
    return out


def assert_same(j, p):
    assert p.events == j.events
    assert p.t == j.t
    assert p.fault_events == j.fault_events
    assert (p.advances, p.supersteps, p.repacks) \
        == (j.advances, j.supersteps, j.repacks)


#: (dtype, superstep, rate bounds, flows, repack_min): each against JAX
CAMPAIGN_DRAINS = {"f64-k1": (np.float64, 1, False, 200, 1024),
                   "f64-k8-repack": (np.float64, 8, False, 150, 16),
                   "f64-k8-bounds": (np.float64, 8, True, 200, 1024),
                   "f32-k8": (np.float32, 8, False, 200, 1024)}


@pytest.mark.parametrize("case", list(CAMPAIGN_DRAINS))
def test_campaign_drain_equals_jax(faulted, case):
    """A campaign tape over a dragonfly drain, bit for bit against JAX at
    supersteps 1 and 8, with and without rate bounds, in f64 and f32,
    and with the repack threshold lowered so the drain repacks under the
    tape and carries the fired bounds.  Across supersteps of 1 and 8 the
    host clock folds a different number of Kahan partial sums (JAX's
    too), so the dates may differ in their last bits; the order of
    completions and of fault fires may not."""
    dtype, k, bounds, flows, repack_min = CAMPAIGN_DRAINS[case]
    sys_, tape = faulted if flows == 200 else campaign_system(flows)
    j, p = run_pair(sys_, tape, dtype, k, bounds, repack_min=repack_min)
    assert_same(j, p)
    assert len(p.fault_events) > 20
    if repack_min < 1024:
        assert p.repacks > 0
    if k == 1:
        q = DrainSim(sys_.e_var, sys_.e_cnst, sys_.e_w, sys_.c_bound,
                     sys_.sizes, eps=1e-5, dtype=dtype, superstep=8,
                     tape=tape, device="cpu")
        q.run()
        assert [f for _, f in q.events] == [f for _, f in p.events]
        assert [c for _, c in q.fault_events] \
            == [c for _, c in p.fault_events]


def test_unfired_tape_equals_no_tape(faulted):
    """A tape whose dates all lie past the drain's end arms the event
    peek on every advance and never fires: the drain is the no-tape
    drain, bit for bit."""
    sys_, tape = faulted
    runs = []
    for t in (None, "late"):
        if t == "late":
            t = (tape[0] + 10.0 * runs[0].t + 1.0, tape[1], tape[2])
        s = DrainSim(sys_.e_var, sys_.e_cnst, sys_.e_w, sys_.c_bound,
                     sys_.sizes, eps=1e-5, dtype=np.float64, superstep=8,
                     tape=t, device="cpu")
        s.run()
        runs.append(s)
    plain, late = runs
    assert late.has_tape and late.fault_events == []
    assert (late.events, late.t, late.advances, late.supersteps) \
        == (plain.events, plain.t, plain.advances, plain.supersteps)
