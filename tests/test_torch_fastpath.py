"""The port's drain fast path (``ops/drain_path.py`` over the port's
``DrainSim``) and the engine capture (``Campaign.from_engine``) against
the JAX package's on the CPU, bit for bit: the engine drains of
``tests/test_drain_superstep.py:339`` (300 flows on the 64-host fat
tree, ``drain/pipeline`` 0 and 1; its partial-advance case, 150 flows
under a 0.002 s run-until bound) and the NAS compute/comm alternation of
``tests/test_nas.py:104-182`` (32 ranks, 2 rounds, ``min-flows:8``,
``superstep:8``).  Each gives equal events and clock, and equal fast-path
counters.  The JAX runs are shared across the checks (a module
fixture)."""

import contextlib

import numpy as np
import pytest
import torch

from simgrid_tpu import s4u as jax_s4u
from simgrid_tpu.parallel import campaign as jax_campaign
from simgrid_tpu.utils.config import config as jax_config
from simgrid_tpu_torch import s4u
from simgrid_tpu_torch.ops import opstats
from simgrid_tpu_torch.parallel import campaign as port_campaign
from simgrid_tpu_torch.utils.config import config as port_config
from simgrid_tpu_torch.workloads.engine_run import (drain, fastpath_counts,
                                                    make_engine, post_flows,
                                                    run_alternation,
                                                    write_platform)

K = 16
BASE = ["network/maxmin-selective-update:no", "network/optim:Full"]
#: name -> (extra --cfg lines, flows, run-until bound step)
DRAINS = {
    "pipeline0": (["drain/fastpath:auto", "drain/min-flows:64",
                   f"drain/superstep:{K}", "drain/pipeline:0"], 300, 0.0),
    "pipeline1": (["drain/fastpath:auto", "drain/min-flows:64",
                   f"drain/superstep:{K}", "drain/pipeline:1"], 300, 0.0),
    "partial": (["drain/fastpath:auto", "drain/min-flows:32",
                 f"drain/superstep:{K}", "drain/pipeline:1"], 150, 0.002),
}
ALTERNATION = ["drain/fastpath:auto", "drain/min-flows:8",
               "drain/superstep:8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's plain path is many small tensor ops: with intra-op
    threads fighting other test processes for the cores it runs 30x
    slower (a 300-flow drain 3 s -> 111 s beside six busy processes), so
    these tests run it on one thread (the results are equal either
    way: the comparisons pass at 1 and at 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _scoped(pkg):
    """The package's flags restored on exit (the port's through
    ``config.scoped``; the JAX package's copied as its conftest does)."""
    if pkg != "jax":
        with port_config.scoped():
            yield
        return
    saved = {n: (f.value, f.default, f.touched)
             for n, f in jax_config._flags.items()}
    try:
        yield
    finally:
        for n, (value, default, touched) in saved.items():
            f = jax_config._flags[n]
            f.value, f.default, f.touched = value, default, touched


@pytest.fixture(autouse=True)
def _fresh_port_config():
    """The port's flags restored after each test (conftest restores the
    JAX package's)."""
    with port_config.scoped():
        yield


def _engine(pkg, cfg, path):
    if pkg == "jax":
        return make_engine(jax_s4u, ["lmm/backend:jax"] + cfg, path)[0]
    return make_engine(s4u, ["lmm/backend:torch"] + cfg, path,
                       device="cpu")[0]


def _drain_run(pkg, path, name):
    extra, flows, step = DRAINS[name]
    with _scoped(pkg):
        e = _engine(pkg, BASE + extra, path)
        rng = np.random.default_rng(5)
        pairs = rng.integers(0, len(e.get_all_hosts()), size=(flows, 2))
        sizes = rng.choice(np.linspace(1e5, 2e6, 12), flows)
        post_flows(e, pairs, sizes)
        out = drain(e, bound_step=step)
        return (out["events"], out["clock"],
                fastpath_counts(e.pimpl.network_model))


def _alternation_run(pkg, path):
    with _scoped(pkg):
        e = _engine(pkg, BASE + ALTERNATION, path)
        events, clock, _ = run_alternation(e, ranks=32, rounds=2, seed=11)
        return events, clock, fastpath_counts(e.pimpl.network_model)


@pytest.fixture(scope="module")
def platform(tmp_path_factory):
    return write_platform(str(tmp_path_factory.mktemp("fp") / "ft.xml"),
                          "fat_tree")


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(jax_runs, key, fn):
    if key not in jax_runs:
        jax_runs[key] = fn()
    return jax_runs[key]


@pytest.mark.parametrize("name", sorted(DRAINS))
def test_engine_drain_equals_jax(platform, jax_runs, name):
    want = _jax(jax_runs, name, lambda: _drain_run("jax", platform, name))
    got = _drain_run("torch", platform, name)
    flows = DRAINS[name][1]
    assert len(got[0]) == flows
    assert got[0] == want[0]                 # order AND timestamps
    assert got[1] == want[1]
    assert got[2] == want[2]
    fp = got[2]
    assert fp["plans"] >= 1 and fp["advances_served"] > 0
    if name == "pipeline0":
        assert fp["speculations"] == 0
    elif name == "pipeline1":
        assert fp["speculations"] > 0 and fp["spec_commits"] > 0
    else:
        # the run-until bound interrupts plans mid-batch: the in-flight
        # speculation is discarded and the served prefix replayed
        assert fp["rollbacks"] > 0 and fp["spec_discards"] > 0
        assert fp["partial_advances"] > 0


def test_alternation_equals_jax(platform, jax_runs):
    """The compute/comm alternation on the superstep path: transition
    payloads absorb the wakes, sends and execs between supersteps."""
    want = _jax(jax_runs, "alternation",
                lambda: _alternation_run("jax", platform))
    before = opstats.snapshot()
    got = _alternation_run("torch", platform)
    d = opstats.diff(before)
    assert len(got[0]) == 2 * 32 * 2
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[2]["advances_served"] > 0
    assert got[2]["transitions_absorbed"] > 0
    assert d["fastpath_advances"] == got[2]["advances_served"]
    assert d["drain_transitions"] == got[2]["transitions_absorbed"]
    assert d["drain_cause_partial_advance"] == got[2]["partial_advances"]


def test_campaign_from_engine_equals_jax(platform):
    """``Campaign.from_engine`` forks the same base scenario as JAX's
    ``capture_plan_snapshot``: the engine's pure drain after the latency
    phase (the fast path off, so the generic loop holds the state)."""
    snaps = {}
    for pkg in ("jax", "torch"):
        with _scoped(pkg):
            e = _engine(pkg, BASE + ["drain/fastpath:off"], platform)
            rng = np.random.default_rng(9)
            pairs = rng.integers(0, 64, size=(200, 2))
            post_flows(e, pairs, rng.choice(np.linspace(1e5, 2e6, 12), 200))
            model = e.pimpl.network_model
            # to the end of the latency phase, then one more advance (the
            # drain under way), reaping completions as the activity
            # layer does
            for _ in range(100):
                lat = model.latency_phase_count
                e.pimpl.surf_solve(-1.0)
                while True:
                    done = model.extract_done_action()
                    if done is None:
                        break
                    done.unref()
                if not lat:
                    break
            mod = jax_campaign if pkg == "jax" else port_campaign
            snaps[pkg] = mod.capture_plan_snapshot(model)
            if pkg == "torch":
                camp = port_campaign.Campaign.from_engine(
                    model, [port_campaign.ScenarioSpec(seed=1)])
                assert camp.plan.device.type == "cpu"
                snaps["camp"] = camp
    want, got = snaps["jax"], snaps["torch"]
    for key in ("e_var", "e_cnst", "e_w", "c_bound", "sizes", "remains",
                "penalty", "v_bound"):
        assert np.array_equal(want[key], got[key]), key
    assert want["link_names"] == got["link_names"]
    assert sorted(want["slot_action"]) == sorted(got["slot_action"])
    assert np.any(got["penalty"] > 0) and np.any(got["remains"] > 0)
    plan = snaps["camp"].plan
    for key in ("e_var", "e_cnst", "e_w", "c_bound", "sizes"):
        assert np.array_equal(np.asarray(getattr(plan, key)), got[key]), key
