"""K16's loops (``simgrid_tpu_torch/kernels/superstep_loop.py``) on the
CPU: the plain loops run the same conditions as the card's graph, so
every superstep's rounds and advances, every chunk's and every chain
stage's rounds are the JAX package's, one for one (tolerance 0).  The
systems are ``bench.py``'s fault stage cut to 32 constraints x 96
flows (solo drains in every superstep shape, a fleet of 8 with
staggered replicas, superstep 4) and a 512 x 4,000 ELL system whose
chain runs two stages of at least 1,024 rows.  The host's guarded
rounds and the STARVED hand-back they needed are gone from the package.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu.parallel.campaign import ScenarioPlan as JaxPlan
from simgrid_tpu.parallel.campaign import ScenarioSpec as JaxSpec
from simgrid_tpu.utils.config import config
from simgrid_tpu_torch.kernels import superstep_loop as k16
from simgrid_tpu_torch.kernels.common import N_CTRL, Work
from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from simgrid_tpu_torch.parallel import campaign as pc
from simgrid_tpu_torch.workloads import bench_solve, fleet_run

STAGE = dict(n_c=32, n_v=96, deg=3, seed=42)
K = 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stage():
    return fleet_run.stage_system(**STAGE)


def logged(sim, log):
    """Wrap ``sim.superstep_batch`` to log each superstep's rounds and
    advances (the deltas of the executor's counters)."""
    orig = sim.superstep_batch

    def batch(*a, **kw):
        r0, a0 = sim.rounds, sim.advances
        out = orig(*a, **kw)
        log.append((sim.rounds - r0, sim.advances - a0))
        return out
    sim.superstep_batch = batch
    return sim


SHAPES = {
    "plain64": (np.float64, 1e-9, {}),
    "plain32": (np.float32, 1e-5, {}),
    "bounds": (np.float64, 1e-9, dict(bounds=True)),
    # a budget tighter than a solve: slots end on the budget, then the
    # fused rescue finishes the advance (JAX's driver)
    "tight_budget": (np.float64, 1e-9, dict(superstep_rounds=6)),
    "stop_early": (np.float64, 1e-9, dict(superstep_rounds=3)),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_supersteps_equal_jax(stage, shape):
    """Superstep by superstep, the plain loops run JAX's rounds and
    advances, and the round loop's iterations are the rounds the control
    words report."""
    e_var, e_cnst, e_w, c_bound, sizes = stage
    dtype, eps, kw = SHAPES[shape]
    kw = dict(kw)
    if kw.pop("bounds", False):
        kw["v_bound"] = np.where(np.arange(len(sizes)) % 3 == 0, 2e6,
                                 -1.0).astype(dtype)
    args = (e_var, e_cnst, e_w.astype(dtype), c_bound.astype(dtype), sizes)
    kw = dict(eps=eps, dtype=dtype, superstep=K, repack_min=16, **kw)
    jlog, plog = [], []
    j = logged(JaxDrainSim(*args, **kw), jlog)
    j.run()
    p = logged(DrainSim(*args, device="cpu", **kw), plog)
    k16.reset_tally()
    p.run()
    assert plog == jlog
    assert (p.rounds, p.advances, p.supersteps, p.repacks) == (
        j.rounds, j.advances, j.supersteps, j.repacks)
    assert p.events == j.events and p.t == j.t
    assert k16.device_tally()["lmm_round"] == p.rounds
    assert k16.device_tally()["slots"] >= p.supersteps


def test_fleet_supersteps_equal_jax(stage):
    """A fleet of 8 whose replicas end at different supersteps (replica
    s drains 96 - 11 s flows, at its own bandwidth scale): after every
    superstep the fleet's rounds and each replica's advances are the JAX
    fleet's."""
    specs = [pc.ScenarioSpec(seed=s, bw_scale=1.0 + 0.1 * s,
                             dead_flows=tuple(range(11 * s)))
             for s in range(8)]
    kw = dict(eps=1e-9, dtype=np.float64, superstep=K, fault_mode="off")
    p = pc.ScenarioPlan(*stage, device="cpu", **kw).executor(specs)
    j = JaxPlan(*stage, **kw).executor(
        [JaxSpec.from_dict(s.to_dict()) for s in specs])
    k16.reset_tally()
    ends = set()
    while j._alive.any():
        j.superstep_all()
        p.superstep_all()
        assert p.rounds == j.rounds
        assert [r.advances for r in p.replicas] == \
            [r.advances for r in j.replicas]
        assert list(p._alive) == list(j._alive)
        ends.add(int(p._alive.sum()))
    assert p.supersteps == j.supersteps
    assert len(ends) > 2                      # the replicas staggered
    for rp, rj in zip(p.replicas, j.replicas):
        assert rp.events == rj.events and rp.t == rj.t
    # a fleet's loop runs while any replica's fixpoint does: at least
    # the slowest replica's rounds, at most every replica's
    n = k16.device_tally()["lmm_round_fleet"]
    assert max(r.advances for r in p.replicas) <= n <= p.rounds


@pytest.mark.parametrize("parallel", [True, False])
def test_chunks_equal_jax(stage, parallel):
    """``solve_arrays`` in chunks of 8 rounds: JAX's rounds, and the
    chunk loop's iterations are those rounds."""
    a = bench_solve.build_arrays(np.random.default_rng(3), 64, 300, 3,
                                 np.float64)
    k16.reset_tally()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="coo",
                               parallel_rounds=parallel, chunk=8)
    j = lmm_jax.solve_arrays(lmm_jax.LmmArrays(*a), 1e-9,
                             parallel_rounds=parallel, chunk=8)
    assert p[3] == j[3] and p[3] > 8
    assert np.array_equal(p[0], np.asarray(j[0]))
    assert k16.device_tally()["lmm_round"] == p[3]


def test_chain_rounds_equal_jax(monkeypatch):
    """The compaction chain at 512 x 4,000 with stages down to 1,024
    rows and finisher chunks of 8: each stage's and each finisher
    chunk's rounds are JAX's."""
    a = bench_solve.build_arrays(np.random.default_rng(13), 512, 4000, 3,
                                 np.float64)
    for mod in (lmm_ell, lmm_jax):
        monkeypatch.setattr(mod, "_CHAIN_MIN_V", 1024)
    jits = []
    for name in ("_ell_chain_stage", "_vc_chunk"):
        orig = getattr(lmm_jax, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            out = _orig(*args, **kw)
            carry = out[1] if _name == "_ell_chain_stage" else out
            jits.append((_name, int(carry[5])))
            return out
        monkeypatch.setattr(lmm_jax, name, wrapped)
    ports = []
    for name, tag in (("chain_stage", "_ell_chain_stage"),
                      ("chain_fetch", "_vc_chunk")):
        orig = getattr(lmm_ell, name)

        def wrapped(*args, _orig=orig, _tag=tag):
            ports.append((_tag, k16.device_tally()["vc_round"]))
            return _orig(*args)
        monkeypatch.setattr(lmm_ell, name, wrapped)
    config["lmm/layout"], config["lmm/chain"] = "ell", "on"
    try:
        j = lmm_jax.solve_arrays(lmm_jax.LmmArrays(*a), 1e-9, chunk=8)
    finally:
        config["lmm/layout"], config["lmm/chain"] = "auto", "auto"
    k16.reset_tally()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="on", chunk=8)
    assert [t for t, _ in ports].count("_ell_chain_stage") == 2
    assert len(ports) > 3                     # several finisher chunks
    assert ports == jits
    assert p[3] == j[3] == ports[-1][1]
    assert np.array_equal(p[0], np.asarray(j[0]))


def ctrl_rows(rows):
    c = torch.zeros((len(rows), N_CTRL), dtype=torch.int32)
    for r, words in enumerate(rows):
        for slot, v in words.items():
            c[r, slot] = v
    return c


def test_pred_plain_is_the_kernels_condition():
    from simgrid_tpu_torch.kernels.common import (ARMED, HALF, IT, LIGHT,
                                                  LIMIT, PENDING, SS_ACTIVE,
                                                  SS_ADV, SS_BUDGET, SS_K,
                                                  SS_NLIVE, SS_ROUNDS,
                                                  SS_STOP, VLIVE)
    run = {ARMED: 1, LIGHT: 3, IT: 2, LIMIT: 9, VLIVE: 5, HALF: 4}
    assert k16.pred_plain(k16.PRED_ROUND, ctrl_rows([run]))
    assert k16.pred_plain(k16.PRED_VC_ROUND, ctrl_rows([run]))
    for slot, v in ((ARMED, 0), (LIGHT, 0), (IT, 9)):
        assert not k16.pred_plain(k16.PRED_ROUND,
                                  ctrl_rows([{**run, slot: v}]))
    assert k16.pred_plain(k16.PRED_ROUND, ctrl_rows([{**run, VLIVE: 4}]))
    assert not k16.pred_plain(k16.PRED_VC_ROUND,
                              ctrl_rows([{**run, VLIVE: 4}]))
    # over a fleet: any replica; a superstep writes each one's SS_ACTIVE
    on = {SS_K: 4, SS_ADV: 1, SS_BUDGET: 100, SS_ROUNDS: 10, SS_NLIVE: 7,
          SS_STOP: 0}
    c = ctrl_rows([{**on, SS_ADV: 4}, on, {**on, SS_NLIVE: 0},
                   {**on, SS_NLIVE: 0, PENDING: 2}])
    assert k16.pred_plain(k16.PRED_SUPERSTEP, c)
    assert c[:, SS_ACTIVE].tolist() == [0, 1, 0, 1]
    c = ctrl_rows([{**on, SS_ROUNDS: 100}])
    assert not k16.pred_plain(k16.PRED_SUPERSTEP, c)
    assert k16.pred_plain(k16.PRED_COUNT, None)


def test_plain_loop_caps_and_nests():
    """A capped loop runs at most ``cap`` bodies; nested loops run their
    bodies under their own conditions; the tallies count iterations."""
    w = Work(4, 4, torch.float64, torch.device("cpu"))
    from simgrid_tpu_torch.kernels.common import ARMED, IT, LIGHT, LIMIT
    w.ctrl[ARMED], w.ctrl[LIGHT], w.ctrl[LIMIT] = 1, 1, 10
    seen = []

    def rnd():
        seen.append(int(w.ctrl[IT]))
        w.ctrl[IT] += 1
    k16.reset_tally()
    loop = k16.DeviceLoop([k16.Loop(k16.PRED_ROUND, w.ctrl, (rnd,), cap=4,
                                    tally="lmm_round")], "chunk",
                          torch.device("cpu"))
    loop.run()
    assert seen == [0, 1, 2, 3]
    loop.run()
    loop.run()
    assert seen == list(range(10))            # the limit, not the cap
    assert k16.device_tally()["lmm_round"] == 10
    outer = []
    nest = k16.DeviceLoop(
        [k16.Loop(k16.PRED_COUNT, None, (
            lambda: outer.append(len(seen)),
            k16.Loop(k16.PRED_COUNT, None, (lambda: seen.append(-1),),
                     cap=2)), cap=3, tally="slots")],
        "probe", torch.device("cpu"))
    nest.run()
    assert outer == [10, 12, 14] and len(seen) == 16
    assert k16.device_tally()["slots"] == 3
    with pytest.raises(ValueError):
        k16.DeviceLoop([], "nope", torch.device("cpu"))


def test_loop_rebuilt_only_when_a_buffer_is_replaced(stage):
    """The executor keeps its loop nest while its buffers stay, and
    builds a new one after a repack replaced them."""
    e_var, e_cnst, e_w, c_bound, sizes = stage
    p = DrainSim(e_var, e_cnst, e_w, c_bound, sizes, eps=1e-9,
                 dtype=np.float64, superstep=K, device="cpu",
                 repack_min=16)
    p.superstep_batch()
    assert p.loop_builds == 1
    while p.repacks == 0:                     # until the live set halves
        p.superstep_batch()
        assert p.loop_builds == 1
    p.superstep_batch()
    assert p.loop_builds == 2 and p.repacks == 1
    p.superstep_batch(k=1, round_budget=40)   # k and budget: no rebuild
    assert p.loop_builds == 2


#: SS_STARVED, FLAG_STARVED and C_SS_STARVED among them
GONE = ("STARVED", r"\bsuperstep_resume\b", r"\bss_resume\b",
        r"\bslot_rounds\b", r"\bSLOT_ROUNDS\b")


@pytest.mark.parametrize("pattern", GONE)
def test_host_round_queue_is_gone(pattern):
    """No module of the port, no CUDA source and not ``chip_smoke.py``
    names the STARVED hand-back or the queued slot rounds."""
    files = [p for p in (ROOT / "simgrid_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    hits = [str(p.relative_to(ROOT)) for p in files
            if re.search(pattern, p.read_text())]
    assert hits == []


def test_loop_source_matches_python():
    """The loop conditions' numbers of ``superstep_loop.cu`` are the
    Python module's."""
    src = (ROOT / "simgrid_tpu_torch" / "csrc" / "superstep_loop.cu") \
        .read_text()
    defs = dict(re.findall(r"^#define (PRED_\w+) (\d+)$", src, re.M))
    assert {k: int(v) for k, v in defs.items()} == {
        k: getattr(k16, k) for k in ("PRED_SUPERSTEP", "PRED_ROUND",
                                     "PRED_VC_ROUND", "PRED_COUNT")}


def test_loop_words_count_after_their_graph_is_dropped():
    """Each built loop counts its iterations in a word of its own; the
    tally and the in-graph launches come from that word and the launches
    its body captured, and a graph dropped before the read (a rebuild
    after a repack) still counts, once."""
    import weakref

    class Owner:
        pass
    k16.reset_tally()
    owner = Owner()
    per = [("lmm_round", {"lmm_round_a": 2, "lmm_round_e": 1}),
           ("slots", {"drain_advance": 1})]
    k16._WORDS.append((weakref.ref(owner, k16._dropped),
                       torch.tensor([7, 3], dtype=torch.int32), per))
    try:
        for dropped in (False, True):         # alive, then dropped
            if dropped:
                del owner
                assert k16._DROPPED[0] == 1
            assert k16.device_tally()["lmm_round"] == 7
            assert k16.device_tally()["slots"] == 3
            launches = k16.graph_launches()
            assert (launches["lmm_round_a"], launches["lmm_round_e"],
                    launches["drain_advance"]) == (14, 7, 3)
        assert k16._DROPPED[0] == 0
        assert all(e[2] is not per for e in k16._WORDS)
    finally:
        k16.reset_tally()
    assert k16.device_tally()["lmm_round"] == 0
    assert "lmm_round_a" not in k16.graph_launches()


def test_cached_loops_rebuild_on_a_baked_scalar(stage):
    """Every scalar a captured wrapper bakes into the graph keys the
    cached loop: a chunk loop at another eps, chunk or arm is a new
    loop, and an executor whose eps changed builds its superstep
    again."""
    e_var, e_cnst, e_w, c_bound, sizes = stage
    p = DrainSim(e_var, e_cnst, e_w, c_bound, sizes, eps=1e-9,
                 dtype=np.float64, superstep=K, device="cpu")
    sys, w, pen = p.sys, p.w, p._pen
    loop = lmm_torch.chunk_loop(sys, w, pen, 1e-9, None, False, False,
                                True, 64)
    assert lmm_torch.chunk_loop(sys, w, pen, 1e-9, None, False, False,
                                True, 64) is loop
    for args in ((1e-5, None, False, False, True, 64),
                 (1e-9, None, False, False, True, 32),
                 (1e-9, None, False, False, False, 64)):
        assert lmm_torch.chunk_loop(sys, w, pen, *args) is not loop
    p.superstep_batch()
    assert p.loop_builds == 1
    p.superstep_batch()
    assert p.loop_builds == 1
    p.eps = 1e-7
    p.superstep_batch()
    assert p.loop_builds == 2
