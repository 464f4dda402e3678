"""The port's config-#4 generator (simgrid_tpu_torch.workloads.dragonfly)
against the JAX engine: the same links, weights, counts, LV08 penalties
and rate bounds as the systems tools/e2e_drain.py and tools/e2e_probe.py
build on the 65,536-host dragonfly; and the port's run functions
(workloads.drain_run) against the JAX DrainSim on the same systems."""

import collections
import os

import numpy as np
import pytest

from simgrid_tpu import s4u
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu_torch.workloads import dragonfly, drain_run

DRAGONFLY = """<?xml version='1.0'?>
<platform version="4.1">
  <zone id="world" routing="Full">
    <cluster id="dfly" prefix="node-" radical="0-65535" suffix=""
             speed="1Gf" bw="125MBps" lat="50us" topology="DRAGONFLY"
             topo_parameters="16,3;4,2;16,2;64"/>
  </zone>
</platform>
"""


def engine_flow_links(tmp_path, flows=0, seed=42, size=1e6, ranks=0):
    """Per-flow (link name, weight) lists, the constraint bounds, the
    flattened arrays, and each flow's penalty and rate bound, of the
    system the JAX engine builds as tools/e2e_drain.py does: ``flows``
    random pairs, or the alltoall of ``ranks`` ranks."""
    path = os.path.join(tmp_path, "dragonfly65k.xml")
    with open(path, "w") as f:
        f.write(DRAGONFLY)
    s4u.Engine._reset()
    try:
        e = s4u.Engine(["e2e", "--cfg=lmm/backend:list",
                        "--cfg=network/maxmin-selective-update:no",
                        "--cfg=network/optim:Full"])
        e.load_platform(path)
        hosts = e.get_all_hosts()
        model = e.pimpl.network_model
        actions = []
        if ranks:
            stride = len(hosts) // ranks
            rh = [hosts[i * stride] for i in range(ranks)]
            for i in range(ranks):
                for j in range(ranks):
                    if i != j:
                        actions.append(model.communicate(rh[i], rh[j],
                                                         size, -1.0))
        rng = np.random.default_rng(seed)
        pairs = rng.integers(0, len(hosts), size=(flows, 2))
        for k in range(flows):
            src, dst = int(pairs[k, 0]), int(pairs[k, 1])
            if src == dst:
                dst = (dst + 1) % len(hosts)
            actions.append(model.communicate(hosts[src], hosts[dst], size,
                                             -1.0))
        for _ in range(400):
            if all(a.variable is not None and a.variable.sharing_penalty > 0
                   for a in actions):
                break
            e.pimpl.surf_solve(-1.0)
        cnsts = list(model.system.active_constraint_set)
        arrays, vars_in_order = lmm_jax.flatten(cnsts)
        var_slot = {id(a.variable): k for k, a in enumerate(actions)}
        slot_flow = [var_slot[id(v)] for v in vars_in_order]
        per_flow = collections.defaultdict(list)
        for i in range(arrays.n_elem):
            per_flow[slot_flow[arrays.e_var[i]]].append(
                (cnsts[arrays.e_cnst[i]].id.name, float(arrays.e_w[i])))
        bounds = {cnsts[c].id.name: float(arrays.c_bound[c])
                  for c in range(arrays.n_cnst)}
        pen = np.empty(len(actions))
        vb = np.empty(len(actions))
        pen[slot_flow] = arrays.v_penalty[:arrays.n_var]
        vb[slot_flow] = arrays.v_bound[:arrays.n_var]
        return per_flow, bounds, arrays, pen, vb
    finally:
        s4u.Engine._reset()


def test_600_flows_equal_engine(tmp_path):
    flows = 600
    eng, eng_bounds, arrays, pen, vb = engine_flow_links(str(tmp_path),
                                                         flows)
    sys = dragonfly.build_system(flows, lv08=True)
    names = dragonfly.link_names(sys)
    gen = collections.defaultdict(list)
    for i in range(sys.n_elem):
        gen[int(sys.e_var[i])].append((names[sys.e_cnst[i]],
                                       float(sys.e_w[i])))
    for k in range(flows):
        assert sorted(gen[k]) == sorted(eng[k]), f"flow {k}"
    assert sys.n_cnst == arrays.n_cnst
    assert sys.n_elem == arrays.n_elem
    assert {n: float(b) for n, b in zip(names, sys.c_bound)} == eng_bounds
    np.testing.assert_array_equal(sys.sizes, np.full(flows, 1e6))
    # LV08: the engine's penalties and TCP-gamma bounds, equal (==)
    np.testing.assert_array_equal(sys.v_penalty, pen)
    np.testing.assert_array_equal(sys.v_bound, vb)


def test_alltoall_16_ranks_equal_engine(tmp_path):
    """The alltoall of tools/e2e_probe.py at 16 ranks: links, weights,
    bounds, counts, LV08 penalties and rate bounds equal the engine's
    flattened arrays."""
    eng, eng_bounds, arrays, pen, vb = engine_flow_links(str(tmp_path),
                                                         ranks=16)
    sys = dragonfly.build_alltoall(16)
    assert len(sys.sizes) == 16 * 15 == len(pen)
    names = dragonfly.link_names(sys)
    gen = collections.defaultdict(list)
    for i in range(sys.n_elem):
        gen[int(sys.e_var[i])].append((names[sys.e_cnst[i]],
                                       float(sys.e_w[i])))
    for k in range(len(sys.sizes)):
        assert sorted(gen[k]) == sorted(eng[k]), f"flow {k}"
    assert (sys.n_cnst, sys.n_elem) == (arrays.n_cnst, arrays.n_elem)
    assert {n: float(b) for n, b in zip(names, sys.c_bound)} == eng_bounds
    np.testing.assert_array_equal(sys.v_penalty, pen)
    np.testing.assert_array_equal(sys.v_bound, vb)


def test_alltoall_320_counts_equal_recorded_row():
    """bench_results/e2e_probe.jsonl row 1: the 320-rank alltoall has
    8,724 constraints, 102,080 flows and 1,275,102 elements."""
    sys = dragonfly.build_alltoall(320)
    assert (sys.n_cnst, len(sys.sizes), sys.n_elem) == \
        (8_724, 102_080, 1_275_102)
    assert np.all(sys.v_penalty > 0) and np.all(sys.v_bound > 0)


def test_run_solve_equals_jax():
    """``drain_run.run_solve`` (the main path's solve, as the card runs
    it) of a 24-rank LV08 alltoall equals lmm_jax.solve_arrays."""
    sys = dragonfly.build_alltoall(24)
    values, row = drain_run.run_solve(sys, device="cpu")
    arrays = drain_run.solve_inputs(sys)
    ref = lmm_jax.solve_arrays(lmm_jax.LmmArrays(*arrays), drain_run.EPS)
    np.testing.assert_array_equal(values, np.asarray(ref[0]))
    assert row["rounds"] == ref[3] and row["flows"] == 24 * 23
    assert not any(row["launches"].values())


def test_engine_plan_equals_jax():
    """``drain_run.run_engine_plan`` (the engine-plan drain: latency
    lanes, one superstep, a transition batch, a partial advance) of a
    16-rank LV08 alltoall, against the JAX DrainSim driven through the
    same ``engine_plan`` sequence."""
    sys = dragonfly.build_alltoall(16)
    sim, row, events = drain_run.run_engine_plan(sys, device="cpu")
    kw, lat = drain_run.plan_setup(sys)
    ref = JaxDrainSim(sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound,
                      sys.sizes, **kw)
    out = drain_run.engine_plan(ref, sys, lat)
    assert events == out["events"]
    assert sim.t == ref.t and sim.advances == ref.advances
    assert row["transition_slots"] == out["transition_slots"] > 0
    assert row["t_engine"] == out["t_engine"]
    assert row["latency_lanes"] == len(lat) > 0
    np.testing.assert_array_equal(sim._pen.numpy(), np.asarray(ref._pen))
    np.testing.assert_array_equal(sim._rem.numpy(), np.asarray(ref._rem))
    assert row["live_left"] == 0 and row["completed"] == len(sys.sizes)


def test_engine_plan_cut_equals_jax():
    """The same sequence cut after 40 advances past the partial advance
    (the depth cut of the full-size run): the events so far equal JAX's,
    and every flow either completed once or is still live."""
    sys = dragonfly.build_alltoall(16)
    sim, row, events = drain_run.run_engine_plan(sys, device="cpu",
                                                 max_advances=40)
    kw, lat = drain_run.plan_setup(sys)
    ref = JaxDrainSim(sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound,
                      sys.sizes, **kw)
    out = drain_run.engine_plan(ref, sys, lat, max_advances=40)
    assert events == out["events"]
    assert sorted(out["live"]) == sorted(
        np.asarray(sim._host_ids())[sim._pen.numpy() > 0])
    assert row["live_left"] > 0
    assert row["completed"] + row["live_left"] == len(sys.sizes)


def test_alltoall_element_order_sets_rounds(tmp_path):
    """The generator's system is the engine's up to the order of the
    elements inside a constraint row (the engine's flatten follows the
    LMM's element lists, the generator flow order), and that order
    decides the rounding of the usage sums and so the local round count:
    at 16 ranks the JAX solve takes 13 rounds on the engine's arrays
    and 14 on the generator's, with the same rates to 1e-12."""
    _, _, arrays, _, _ = engine_flow_links(str(tmp_path), ranks=16)
    eng = lmm_jax.solve_arrays(arrays, drain_run.EPS)
    gen = lmm_jax.solve_arrays(lmm_jax.LmmArrays(*drain_run.solve_inputs(
        dragonfly.build_alltoall(16))), drain_run.EPS)
    assert (eng[3], gen[3]) == (13, 14)
    nv = arrays.n_var
    np.testing.assert_allclose(np.sort(np.asarray(eng[0])[:nv]),
                               np.sort(np.asarray(gen[0])[:nv]),
                               rtol=1e-12)


def test_100k_counts_equal_recorded_row():
    """bench_results/e2e_drain.jsonl row 2: 141,871 constraints and
    1,241,658 elements for the 100,000-flow drain."""
    sys = dragonfly.build_system(100_000)
    assert sys.n_cnst == 141_871
    assert sys.n_elem == 1_241_658
    assert len(sys.sizes) == 100_000
    assert sys.e_var.max() == 99_999


@pytest.mark.parametrize("rank", [0, 1, 10, 65535])
def test_host_ranks_follow_name_order(rank):
    ranks = dragonfly.host_ranks(65536)
    names = sorted(f"node-{i}" for i in range(65536))
    assert ranks[rank] == int(names[rank][5:])


@pytest.mark.parametrize("shape", [dict(superstep=16), dict(fused=True)])
def test_run_drain_equals_jax(shape):
    """The main path's driver (``drain_run.run_drain``, as the card runs
    it) on the CPU against the JAX DrainSim on the same 300 dragonfly
    flows: events, clock and advances equal, and the row reports them."""
    sys = dragonfly.build_system(300)
    kw = dict(shape)
    if "superstep" in kw:
        kw["superstep_rounds"] = kw["superstep"] * 512
    sim, row = drain_run.run_drain(sys, device="cpu", **kw)
    ref = JaxDrainSim(sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound,
                      sys.sizes, eps=drain_run.EPS,
                      done_eps=drain_run.DONE_EPS, dtype=np.float64, **kw)
    ref.run()
    assert sim.events == ref.events
    assert sim.t == ref.t
    assert sim.advances == ref.advances == row["advances"]
    assert row["flows"] == 300 and row["n_elem"] == sys.n_elem
    assert row["t_sim"] == ref.t and row["wall_s"] > 0
    # the plain CPU path launches no kernel
    assert not any(row["launches"].values())


def test_engine_plan_held_windows_equal_jax():
    """``drain_run.run_engine_plan_held`` (the engine plan to its end,
    each window after the partial advance and after a repack also run
    from a handover on the CPU) of 600 random flows with LV08 values:
    the drain equals the JAX DrainSim through the same ``engine_plan``,
    and every repack opened a window."""
    sys = dragonfly.build_system(600, lv08=True)
    sim, windows = drain_run.run_engine_plan_held(sys, device="cpu",
                                                  repack_min=64)
    kw, lat = drain_run.plan_setup(sys)
    ref = JaxDrainSim(sys.e_var, sys.e_cnst, sys.e_w, sys.c_bound,
                      sys.sizes, **kw, repack_min=64)
    drain_run.engine_plan(ref, sys, lat)
    assert sim.events == ref.events and sim.t == ref.t
    assert sim.repacks == ref.repacks > 0
    assert len(windows) == sim.repacks + 1
    assert sum(w["advances"] for w in windows) <= sim.advances
