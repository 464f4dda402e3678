"""The port's resource models (``kernel/resource.py``, ``models/``,
``kernel/engine.py`` ``surf_solve``) against the JAX package's on the
CPU, bit for bit: seeded CM02 and LV08 communications and Cas01
executions on the 64-host fat tree, stepped ``surf_solve`` by
``surf_solve``; after every advance the clocks, each action's state,
remains and rate, and the network System's flattened arrays are equal.
Each configuration runs with ``lmm/backend:list`` on both sides, and
with the port's ``torch`` backend on the CPU against JAX's ``jax``."""

import contextlib

import numpy as np
import pytest
import torch

from simgrid_tpu import s4u as jax_s4u
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.utils.config import config as jax_config
from simgrid_tpu_torch import s4u
from simgrid_tpu_torch.ops import lmm_torch
from simgrid_tpu_torch.utils.config import config as port_config
from simgrid_tpu_torch.workloads.engine_run import make_engine, write_platform

FLOWS = 40
EXECS = 16

#: (network/model, network/optim, cpu/optim)
MODELS = {"cm02_lazy": ("CM02", "Lazy", "Lazy"),
          "lv08_full": ("LV08", "Full", "Full")}
BACKENDS = {"list": ("list", "list"), "device": ("jax", "torch")}


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


def _flat(pkg, system):
    flat = (lmm_jax if pkg == "jax" else lmm_torch).flatten(
        list(system.active_constraint_set))
    if flat is None:
        return None
    a, _ = flat
    n_e, n_c, n_v = a.n_elem, a.n_cnst, a.n_var
    return (a.e_var[:n_e].tolist(), a.e_cnst[:n_e].tolist(),
            a.e_w[:n_e].tolist(), a.c_bound[:n_c].tolist(),
            a.v_penalty[:n_v].tolist(), a.v_bound[:n_v].tolist())


def _drive(pkg, path, model_key, backend_key):
    """Post the seeded workload and step it to its end; one record per
    advance: (dt, clock, [(state, remains, rate) per action], flat
    network system)."""
    net, net_optim, cpu_optim = MODELS[model_key]
    backend = BACKENDS[backend_key][0 if pkg == "jax" else 1]
    cfg = [f"network/model:{net}", f"network/optim:{net_optim}",
           f"cpu/optim:{cpu_optim}", f"lmm/backend:{backend}",
           "drain/fastpath:off"]
    mod = jax_s4u if pkg == "jax" else s4u
    with _scoped(pkg):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        e, _ = make_engine(mod, cfg, path, **kw)
        hosts = e.get_all_hosts()
        model = e.pimpl.network_model
        rng = np.random.default_rng(21)
        pairs = rng.integers(0, len(hosts), size=(FLOWS, 2))
        sizes = rng.choice(np.linspace(1e5, 3e6, 9), FLOWS)
        rates = rng.choice([-1.0, -1.0, 2e7, 5e7], FLOWS)
        actions = []
        for k in range(FLOWS):
            s, d = int(pairs[k, 0]), int(pairs[k, 1])
            if s == d:
                d = (d + 1) % len(hosts)
            actions.append(model.communicate(hosts[s], hosts[d],
                                             float(sizes[k]),
                                             float(rates[k])))
        for h in rng.integers(0, len(hosts), EXECS):
            actions.append(hosts[int(h)].cpu.execution_start(
                float(rng.choice(np.linspace(2e6, 9e7, 7)))))
        records = []
        for _ in range(10_000):
            if not any(len(m.started_action_set) for m in e.pimpl.models):
                break
            dt = e.pimpl.surf_solve(-1.0)
            acts = [(a.get_state().name, a.get_remains_no_update(),
                     a.get_rate() if a.variable is not None else None)
                    for a in actions]
            records.append((dt, e.pimpl.now, acts,
                            _flat(pkg, model.system)))
            # reap as the kernel's activity layer does: the action is
            # destroyed and its variable freed
            for m in e.pimpl.models:
                while True:
                    done = m.extract_done_action()
                    if done is None:
                        break
                    done.unref()
        mod.Engine._reset()
        return records


#: three hosts, two links, a bandwidth profile on one (set_bandwidth at
#: each event) and a latency profile on the other (set_latency)
TRACED = """<?xml version='1.0'?>
<platform version="4.1">
  <zone id="z" routing="Full">
    <host id="a" speed="1Gf"/>
    <host id="b" speed="1Gf"/>
    <host id="c" speed="2Gf"/>
    <link id="l1" bandwidth="10MBps" latency="1ms"/>
    <link id="l2" bandwidth="20MBps" latency="2ms"/>
    <route src="a" dst="b"><link_ctn id="l1"/></route>
    <route src="b" dst="c"><link_ctn id="l2"/></route>
    <route src="a" dst="c"><link_ctn id="l1"/><link_ctn id="l2"/></route>
  </zone>
  <trace id="bw" periodicity="1.0">
0 10000000
0.05 4000000
0.2 25000000
  </trace>
  <trace id="lat" periodicity="0.5">
0 0.002
0.1 0.0005
  </trace>
  <trace_connect trace="bw" element="l1" kind="BANDWIDTH"/>
  <trace_connect trace="lat" element="l2" kind="LATENCY"/>
</platform>
"""


@pytest.fixture(scope="module")
def platform(tmp_path_factory):
    return write_platform(str(tmp_path_factory.mktemp("models") / "ft.xml"),
                          "fat_tree")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "traced.xml"
    path.write_text(TRACED)
    return str(path)


@pytest.mark.parametrize("backend_key", sorted(BACKENDS))
@pytest.mark.parametrize("model_key", sorted(MODELS))
def test_models_step_by_step_equal_jax(platform, model_key, backend_key):
    want = _drive("jax", platform, model_key, backend_key)
    got = _drive("torch", platform, model_key, backend_key)
    assert len(want) > 20, "the workload ended too early to check much"
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a[0] == b[0] and a[1] == b[1], f"advance {i}: dt/clock"
        assert a[2] == b[2], f"advance {i}: action states/remains/rates"
        assert a[3] == b[3], f"advance {i}: flattened network system"


@pytest.mark.parametrize("backend_key", sorted(BACKENDS))
def test_profiles_step_by_step_equal_jax(traced, backend_key):
    """``surf_solve``'s profile events (the future event set, a
    bandwidth and a latency trace) change the links mid-run the same
    way in both packages."""
    want = _drive("jax", traced, "lv08_full", backend_key)
    got = _drive("torch", traced, "lv08_full", backend_key)
    assert len(want) > 20
    assert got == want


def test_timers_fire_in_date_order():
    e = s4u.Engine(["timers"], device="cpu")
    fired = []
    for date, tag in ((0.3, "b"), (0.1, "a"), (0.3, "c"), (0.2, "x")):
        timer = e.pimpl.timer_set(date, lambda tag=tag: fired.append(tag))
        if tag == "x":
            timer.remove()
    assert e.pimpl.next_timer_date() == 0.1
    e.pimpl.now = 0.3
    assert e.pimpl.execute_timers() and fired == ["a", "b", "c"]
    assert e.pimpl.next_timer_date() == -1.0


def test_engine_needs_a_device_by_default():
    """Without ``device=`` the engine runs on the card, and raises here
    where there is none (the port never moves to the CPU by itself)."""
    if torch.cuda.is_available():
        e = s4u.Engine(["default-device"])
        assert e.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s4u.Engine(["default-device"])
    e = s4u.Engine(["cpu"], device="cpu")
    assert e.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="A3b"):
        e.run()
    with pytest.raises(NotImplementedError, match="A3b"):
        e.load_deployment("deploy.xml")
