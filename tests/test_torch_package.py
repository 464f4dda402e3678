"""Package rules of simgrid_tpu_torch: it (and chip_smoke.py) imports
neither jax nor anything of simgrid_tpu, entry points refuse to fall
back to the CPU silently, and every kernel wrapper runs its plain
PyTorch version on CPU tensors without counting a launch."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simgrid_tpu_torch.kernels import common, launch_counts
from simgrid_tpu_torch.kernels import drain_advance as k2
from simgrid_tpu_torch.kernels import livefirst_repack as k4
from simgrid_tpu_torch.kernels import lmm_round as k1
from simgrid_tpu_torch.kernels import probe_gather as k12
from simgrid_tpu_torch.kernels import probe_loop as k15
from simgrid_tpu_torch.kernels import probe_scan as k14
from simgrid_tpu_torch.kernels import probe_segsum as k13
from simgrid_tpu_torch.kernels import superstep_commit as k3
from simgrid_tpu_torch.kernels import superstep_loop as k16
from simgrid_tpu_torch.kernels import transition_scatter as k5
from simgrid_tpu_torch.kernels import warm_init as k6
from simgrid_tpu_torch.ops import lmm_torch
from simgrid_tpu_torch.ops.lmm_arrays import LmmArrays
from simgrid_tpu_torch.ops.lmm_host import LmmFlags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "simgrid_tpu_torch")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    # the port's tools; tools/torch_parity_*.py hold the port against the
    # JAX package on the host, as the tests do, and import both
    tools = os.path.join(ROOT, "tools")
    out += [os.path.join(tools, f) for f in os.listdir(tools)
            if f.startswith("torch_") and f.endswith(".py")
            and not f.startswith("torch_parity_")]
    return sorted(out)


def forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top == "jax" or top == "simgrid_tpu"


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not forbidden(n), f"{path} imports {n}"


def test_import_loads_no_jax_or_reference():
    code = (
        "import sys, runpy\n"
        "import simgrid_tpu_torch, simgrid_tpu_torch.convert\n"
        "import simgrid_tpu_torch.ops.lmm_drain\n"
        "import simgrid_tpu_torch.ops.lmm_torch\n"
        "import simgrid_tpu_torch.workloads.dragonfly\n"
        "import simgrid_tpu_torch.ops.lmm_warm\n"
        "import simgrid_tpu_torch.workloads.churn\n"
        "import simgrid_tpu_torch.workloads.lazy_alltoall\n"
        "import simgrid_tpu_torch.workloads.bench_solve\n"
        "import simgrid_tpu_torch.ops.lmm_ell\n"
        "import simgrid_tpu_torch.kernels.ell_round\n"
        "import simgrid_tpu_torch.kernels.vc_round\n"
        "import simgrid_tpu_torch.kernels.ell_chain\n"
        "import simgrid_tpu_torch.kernels.dag_walk\n"
        "import simgrid_tpu_torch.faults\n"
        "import simgrid_tpu_torch.collectives\n"
        "import simgrid_tpu_torch.utils.rngstream\n"
        "import simgrid_tpu_torch.workloads.fault_drain\n"
        "import simgrid_tpu_torch.workloads.collective_run\n"
        "import simgrid_tpu_torch.kernels\n"
        "import simgrid_tpu_torch.kernels.fleet_materialize\n"
        "import simgrid_tpu_torch.ops.lmm_batch\n"
        "import simgrid_tpu_torch.parallel.campaign\n"
        "import simgrid_tpu_torch.workloads.fleet_run\n"
        "import simgrid_tpu_torch.probes.opcost\n"
        "import simgrid_tpu_torch.probes.scaling\n"
        "import simgrid_tpu_torch.exceptions\n"
        "import simgrid_tpu_torch.utils.signal\n"
        "import simgrid_tpu_torch.utils.config\n"
        "import simgrid_tpu_torch.platform.units\n"
        "import simgrid_tpu_torch.platform.dtd\n"
        "import simgrid_tpu_torch.platform.xml\n"
        "import simgrid_tpu_torch.kernel.profile\n"
        "import simgrid_tpu_torch.kernel.resource\n"
        "import simgrid_tpu_torch.kernel.engine\n"
        "import simgrid_tpu_torch.routing\n"
        "import simgrid_tpu_torch.models.host\n"
        "import simgrid_tpu_torch.models.cpu\n"
        "import simgrid_tpu_torch.models.network\n"
        "import simgrid_tpu_torch.models.registry\n"
        "import simgrid_tpu_torch.s4u\n"
        "import simgrid_tpu_torch.ops.drain_path\n"
        "import simgrid_tpu_torch.workloads.engine_run\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "runpy.run_path('tools/torch_opcost.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'simgrid_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def tiny_arrays():
    return LmmArrays(np.array([0, 1, 1], np.int32),
                     np.array([0, 0, 1], np.int32),
                     np.array([1.0, 1.0, 1.0]), np.array([1.0, 2.0]),
                     np.zeros(2, bool), np.ones(2), np.full(2, -1.0),
                     3, 2, 2)


def test_drain_dtype_defaults_agree_with_jax():
    """A drain or fleet that leaves ``dtype`` out runs the same program
    in both packages (the solo drain float32, the fleet float64)."""
    import inspect
    from simgrid_tpu.ops import lmm_batch as jb
    from simgrid_tpu.ops import lmm_drain as jd
    from simgrid_tpu_torch.ops import lmm_batch as pb
    from simgrid_tpu_torch.ops import lmm_drain as pd

    def default(cls):
        return np.dtype(inspect.signature(cls).parameters["dtype"].default)
    assert default(pd.DrainSim) == default(jd.DrainSim) == np.float32
    assert default(pb.BatchDrainSim) == default(jb.BatchDrainSim) \
        == np.float64


def test_fleet_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from simgrid_tpu_torch.ops.lmm_batch import (BatchDrainSim,
                                                 ReplicaOverrides,
                                                 solve_arrays_batch)
    from simgrid_tpu_torch.parallel import Campaign, ScenarioSpec
    a = tiny_arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchDrainSim(a.e_var, a.e_cnst, a.e_w, a.c_bound, np.ones(2),
                      [ReplicaOverrides()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_arrays_batch(a.e_var, a.e_cnst, a.e_w, a.c_bound[None],
                           a.c_fatpipe, a.v_penalty[None],
                           a.v_bound[None], 1e-9)
    camp = Campaign(a.e_var, a.e_cnst, a.e_w, a.c_bound, np.ones(2),
                    [ScenarioSpec()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        camp.run_batched()
    res = Campaign(a.e_var, a.e_cnst, a.e_w, a.c_bound, np.ones(2),
                   [ScenarioSpec()], device="cpu").run_batched()
    assert len(res[0].events) == 2 and res[0].error is None


def test_entry_points_need_a_device():
    a = tiny_arrays()
    if torch.cuda.is_available():
        from simgrid_tpu_torch import resolve_device
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lmm_torch.solve_arrays(a, 1e-9)
    from simgrid_tpu_torch.ops.lmm_drain import DrainSim
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DrainSim(a.e_var, a.e_cnst, a.e_w, a.c_bound, np.ones(2))
    values, _, _, rounds = lmm_torch.solve_arrays(a, 1e-9, device="cpu")
    assert rounds > 0 and np.all(values > 0)
    from simgrid_tpu_torch.workloads import bench_solve, churn
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lmm_torch.solve_arrays(a, 1e-9, layout="ell")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_solve.run_bench_solve(arrays=a, reps=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        churn.run_churn(n_v=40, clusters=2, chain=3, steps=1)
    _, row = bench_solve.run_bench_solve(arrays=a, reps=0, device="cpu",
                                         layout="ell")
    assert row["path"] == "dense" and row["rounds"] == rounds
    from simgrid_tpu_torch.collectives import CollectiveSpec, HostMaestro
    from simgrid_tpu_torch.workloads import collective_run
    dc = CollectiveSpec("allreduce", "rdb", 4).build()
    from simgrid_tpu_torch.probes.opcost import run_opcost
    from simgrid_tpu_torch.probes.scaling import run_scaling
    for entry in (lambda: dc.make_sim(superstep=4),
                  lambda: HostMaestro(dc),
                  lambda: collective_run.run_case(CollectiveSpec()),
                  lambda: run_opcost(scale=1 / 256),
                  lambda: run_scaling(scale=1 / 256)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_layout_choice_follows_the_device():
    """``layout="auto"`` and ``chain="auto"`` resolve as the JAX package
    resolves them with the device in place of its platform: ELL and the
    chain on the card, COO on the CPU; unknown names raise."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert not lmm_torch.uses_ell("auto", cpu)
    assert lmm_torch.uses_ell("auto", card)
    assert lmm_torch.uses_ell("ell", cpu)
    assert not lmm_torch.uses_ell("coo", card)
    assert not lmm_torch.uses_chain("auto", cpu)
    assert lmm_torch.uses_chain("auto", card)
    assert lmm_torch.uses_chain("on", cpu)
    assert not lmm_torch.uses_chain("off", card)
    for bad in (lambda: lmm_torch.uses_ell("csr", cpu),
                lambda: lmm_torch.uses_chain("maybe", cpu),
                lambda: LmmFlags(layout="csr"),
                lambda: LmmFlags(chain="maybe")):
        with pytest.raises(ValueError):
            bad()


def small_state():
    cpu = torch.device("cpu")
    a = tiny_arrays()
    sys_ = lmm_torch.to_device_system(a.e_var, a.e_cnst, a.e_w, a.c_bound,
                                      2, torch.float64, cpu)
    return sys_, common.Work(2, 2, torch.float64, cpu)


def test_wrappers_run_plain_version_on_cpu():
    before = launch_counts()
    sys_, w = small_state()
    pen = torch.ones(2, dtype=torch.float64)
    assert k1.lmm_init(sys_, w, pen, 1e-9) is True
    n = 0
    while k1.lmm_round(sys_, w, pen, 1e-9):
        n += 1
    assert n == int(w.ctrl[common.IT]) and int(w.ctrl[common.LIGHT]) == 0

    # the same rounds through the plain functions directly
    sys2, w2 = small_state()
    k1.lmm_init_plain(sys2, w2, pen, 1e-9)
    while k1.lmm_round_plain(sys2, w2, pen, 1e-9):
        pass
    assert torch.equal(w.v_value, w2.v_value)

    rem = torch.tensor([1.0, 3.0], dtype=torch.float64)
    thresh = torch.full((2,), 0.5, dtype=torch.float64)
    assert k2.drain_advance(pen, rem, thresh, w) is True
    assert float(w.fctrl[common.DT]) == pytest.approx(2.0)
    assert w.done.tolist() == [True, False]

    packed = torch.zeros(k3.packed_size(4, 2), dtype=torch.float64)
    ids = torch.arange(2, dtype=torch.int32)
    k3.superstep_reset(pen, w, 4, 100, 0)
    assert k16.pred_plain(k16.PRED_SUPERSTEP, w.ctrl) is True
    k3.superstep_finish(sys_.e_var, sys_.e_w, pen, packed, w)
    # flow 0 retired in the advance above: one live flow, two elements
    assert int(packed[4]) == 1 and int(packed[6]) == 2

    rp = k4.livefirst_repack(sys_, torch.tensor([0.0, 1.0],
                                                dtype=torch.float64),
                             rem, thresh, ids, 1, 8, 2)
    assert rp.ids.tolist() == [1]
    assert rp.sys.e_w.tolist()[:2] == [1.0, 1.0]
    # K12-K15 (the op-cost probe's kernels)
    tab = torch.tensor([1.5, 2.5, 3.5], dtype=torch.float64)
    idx = torch.tensor([[2, 0], [1, 1]] * 4, dtype=torch.int32)
    assert k12.probe_gather(tab, idx, "smem").tolist() == \
        [[3.5, 1.5], [2.5, 2.5]] * 4
    wt = torch.full((8, 2), 0.25, dtype=torch.float64)
    assert k13.probe_segsum(idx, wt, 3, "atomic").tolist() == [1.0, 2.0, 1.0]
    assert k14.probe_scan(tab, "block").tolist() == [1.5, 4.0, 7.5]
    assert k15.probe_loop(tab, idx, 2, "graph").shape == (8, 1)
    assert k15.probe_double(tab).tolist() == [3.0, 5.0, 7.0]
    assert launch_counts() == before

    with pytest.raises(ValueError):
        k2.drain_advance(pen, rem, thresh.to("meta"), w)
    with pytest.raises(ValueError):
        k12.probe_gather(tab, idx.to("meta"))
    with pytest.raises(ValueError):
        k13.probe_segsum(idx, wt.to("meta"), 3)
    with pytest.raises(ValueError):
        k14.probe_scan(tab.to("meta"))
    with pytest.raises(ValueError):
        k15.probe_double(tab.to("meta"))


def test_superstep_commit_plain_ring_order():
    _, w = small_state()
    w.done = torch.tensor([True, True, False, True])
    w.ctrl[common.ADV_GO] = 1
    w.ctrl[common.ADV_CONV] = 1
    w.ctrl[common.SS_NEV] = 2
    w.fctrl[common.DT] = 0.25
    packed = torch.zeros(k3.packed_size(2, 8), dtype=torch.float64)
    ids = torch.tensor([7, 5, 3, 1], dtype=torch.int32)
    assert k3.superstep_commit(w, ids, packed, 2, 8) is True
    o = k3.N_STATS + 4
    assert packed[o + 2:o + 5].tolist() == [0.25] * 3
    assert packed[o + 8 + 2:o + 8 + 5].tolist() == [7.0, 5.0, 1.0]
    assert int(w.ctrl[common.SS_NEV]) == 5
    assert int(w.ctrl[common.SS_ADV]) == 1


def test_new_wrappers_run_plain_version_on_cpu():
    """K2's forced mode, K5, K1's bound/FATPIPE/global arms and K4 with
    bound rows take their plain versions on CPU tensors and count no
    launch."""
    before = launch_counts()
    sys_, w = small_state()
    pen = torch.ones(2, dtype=torch.float64)
    rem = torch.tensor([1.0, 3.0], dtype=torch.float64)
    thresh = torch.full((2,), 0.5, dtype=torch.float64)
    w.v_value.copy_(torch.tensor([1.0, 1.0], dtype=torch.float64))
    assert k2.drain_forced_advance(pen, rem, thresh, w, 0.75) is True
    assert w.done.tolist() == [True, False]
    assert rem.tolist() == [0.0, 2.25] and int(w.ctrl[common.LIVE_ACC]) == 1

    targets = [sys_.e_var.clone(), sys_.e_cnst.clone(), sys_.e_w.clone(),
               sys_.c_bound.clone(), pen.clone(), rem.clone(),
               thresh.clone(), torch.full((2,), -1.0, dtype=torch.float64)]
    payload = torch.tensor([1.0, 4.0, 0.0, 1.0, 7.5, 2.5],
                           dtype=torch.float64)
    assert k5.transition_scatter(payload, [(3, 0, 1), (7, 2, 2)],
                                 targets) is True
    assert targets[3].tolist() == [1.0, 4.0]
    assert targets[7].tolist() == [7.5, 2.5]

    fat = sys_._replace(c_fatpipe=torch.tensor([True, False]))
    vb = torch.tensor([0.25, -1.0], dtype=torch.float64)
    pen = torch.ones(2, dtype=torch.float64)
    for arms in (dict(has_bounds=True, has_fatpipe=True),
                 dict(has_bounds=True, global_rounds=True)):
        k1.lmm_init(fat, w, pen, 1e-9, has_fatpipe=True)
        while k1.lmm_round(fat, w, pen, 1e-9, vb, **arms):
            pass
        assert w.v_value.tolist()[0] == 0.25      # the bound binds

    rp = k4.livefirst_repack(sys_, torch.tensor([0.0, 1.0],
                                                dtype=torch.float64),
                             rem, thresh, torch.arange(2, dtype=torch.int32),
                             1, 8, 2, vb)
    assert rp.vb.tolist() == [-1.0]
    assert launch_counts() == before


def test_warm_wrappers_run_plain_version_on_cpu():
    """K5's delta scatter (with a bool target) and K6 take their plain
    versions on CPU tensors and count no launch."""
    before = launch_counts()
    sys_, w = small_state()
    fat = sys_._replace(c_fatpipe=torch.tensor([False, False]))
    masters = [fat.e_var, fat.e_cnst, fat.e_w, fat.c_bound, fat.c_fatpipe,
               torch.ones(2, dtype=torch.float64),
               torch.full((2,), -1.0, dtype=torch.float64)]
    payload = torch.tensor([1.0, 1.0, 2.0, 5.0], dtype=torch.float64)
    assert k5.delta_scatter(payload, [(4, 0, 2)], masters) is True
    assert masters[4].tolist() == [False, True]
    w.remaining.copy_(torch.tensor([9.0, 9.0], dtype=torch.float64))
    mc = torch.tensor([1], dtype=torch.int32)
    assert k6.warm_init(fat, w, masters[5], mc, 1e-9) is True
    # row 1 (modified) restarts cold; row 0 keeps its previous state
    assert w.remaining.tolist() == [9.0, 2.0]
    assert w.light.tolist() == [False, True]
    assert w.v_fixed.tolist() == [True, False]
    assert int(w.ctrl[common.LIGHT]) == 1 and int(w.ctrl[common.IT]) == 0
    assert launch_counts() == before


def test_ell_wrappers_run_plain_version_on_cpu():
    """K7, K8, K9, K6's ELL arm and K5's ELL deltas take their plain
    versions on CPU tensors and count no launch."""
    from simgrid_tpu_torch.kernels import ell_chain as k9
    from simgrid_tpu_torch.kernels import ell_round as k7
    from simgrid_tpu_torch.kernels import vc_round as k8
    from simgrid_tpu_torch.ops import lmm_ell
    before = launch_counts()
    cpu = torch.device("cpu")
    ell = lmm_ell.ell_from_arrays(tiny_arrays())
    sys_, pen, vb = lmm_ell.dense_system(ell, cpu)
    w = common.EllWork(sys_.n_v, sys_.n_c, sys_.wc, torch.float64, cpu)
    assert k7.ell_init(sys_, w, pen, 1e-9, vb) is True
    assert k8.vc_round(sys_, w, pen, 1e-9) is True
    assert k7.ell_round(sys_, w, pen, 1e-9, vb) is False   # converged
    mc = torch.tensor([1], dtype=torch.int32)
    assert k6.warm_init_ell(sys_, w, pen, mc, 1e-9) is True
    assert k7.ell_round(sys_, w, pen, 1e-9, vb, global_rounds=True) is True
    cs = k9.ChainState(sys_._replace(cv_var=None, cv_w=None, cv_valid=None),
                       pen, torch.arange(2, dtype=torch.int32),
                       common.Work(2, 2, torch.float64, cpu))
    assert k9.chain_arm(cs, -1, -1, first=True) is True
    assert k9.chain_stage(cs, 1) is True and cs.sys.n_v == 1
    out = torch.zeros(4 + 2 + 4, dtype=torch.float64)
    assert k9.chain_fetch(cs, out) is True
    masters = [sys_.cv_var.clone(), sys_.cv_w.clone(), sys_.cv_valid.clone(),
               sys_.vc_cnst.clone(), sys_.vc_valid.clone(),
               sys_.vc_w.clone()]
    payload = torch.tensor([0.0, -1.0], dtype=torch.float64)
    assert k5.ell_delta_scatter(payload, [(2, 0, 1)], masters) is True
    assert not bool(masters[2].view(-1)[0])
    assert launch_counts() == before


def test_event_arm_wrappers_run_plain_version_on_cpu():
    """K2's event arm, K3's tape and collective arms and K10 take their
    plain versions on CPU tensors and count no launch."""
    from simgrid_tpu_torch.kernels import dag_walk as k10
    before = launch_counts()
    sys_, w = small_state()
    pen = torch.tensor([1.0, 0.0], dtype=torch.float64)
    rem = torch.tensor([1.0, 3.0], dtype=torch.float64)
    thresh = torch.full((2,), 0.5, dtype=torch.float64)
    ready = torch.tensor([float("inf"), 0.5], dtype=torch.float64)
    tape_t = torch.tensor([0.5, 4.0], dtype=torch.float64)
    tape = (torch.tensor([1, 0], dtype=torch.int32),
            torch.tensor([0.25, 1.0], dtype=torch.float64))
    cb = sys_.c_bound.clone()
    ids = torch.arange(2, dtype=torch.int32)
    packed = torch.zeros(k3.packed_size(4, 6), dtype=torch.float64)
    k3.superstep_reset(pen, w, 4, 100, 0, t0=0.0, tpos=0, ready=ready,
                       clk=torch.zeros(2, dtype=torch.float64))
    assert int(w.ctrl[common.PENDING]) == 1
    assert k16.pred_plain(k16.PRED_SUPERSTEP, w.ctrl) is True
    w.v_value.copy_(torch.tensor([1.0, 1.0], dtype=torch.float64))
    w.ctrl[common.LIGHT] = 0
    # the tape date and the activation date tie at 0.5 < dt_plan = 1.0
    assert k2.drain_advance(pen, rem, thresh, w, gated=True, tape_t=tape_t,
                            ready=ready) is True
    assert float(w.fctrl[common.DT]) == 0.5
    assert [int(w.ctrl[s]) for s in (common.FIRE, common.FFIRE,
                                     common.AANY)] == [1, 1, 1]
    assert k3.superstep_commit(w, ids, packed, 4, 6, tape=tape, c_bound=cb,
                               n_c=2, ready=ready, pen=pen) is True
    o = k3.N_STATS + 8
    # the fault entry, then the activation of flow 1 (id -(1 + 2 + 1))
    assert packed[o + 6:o + 8].tolist() == [-2.0, -4.0]
    assert cb.tolist()[1] == 0.25 and int(w.ctrl[common.TPOS]) == 1
    assert pen.tolist() == [1.0, 1.0] and ready.tolist()[1] == float("inf")
    pred = torch.tensor([0, 1], dtype=torch.int32)
    w.done = torch.tensor([True, False])
    assert k10.dag_walk(w, torch.tensor([0, 0], dtype=torch.int32),
                        torch.tensor([1, 2], dtype=torch.int32), pred,
                        ready, torch.tensor([0.0, 0.125],
                                            dtype=torch.float64)) is True
    assert pred.tolist() == [0, 0] and ready.tolist()[1] == 0.625
    assert int(w.ctrl[common.PENDING]) == 1
    assert launch_counts() == before
