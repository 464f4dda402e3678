"""The port's drain executor (simgrid_tpu_torch.ops.lmm_drain.DrainSim)
against the JAX package's, on the CPU: completion events (times and
flow ids), the clock, and the advance, superstep and repack counts must
be exactly equal in every executor shape, with and without rate bounds,
and through the engine plan's calls (apply_transitions, partial_advance,
solve_rates).

The flow set is a seeded random-pair drain on the 64-host fat tree,
built once through the JAX engine's platform and routing stack (LV08:
each flow carries its penalty and its TCP-gamma rate bound) and
flattened; both executors get the same numpy arrays.
"""

import os

import numpy as np
import pytest

from simgrid_tpu import s4u
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.kernels.superstep_loop import device_tally, reset_tally
from simgrid_tpu_torch.ops.lmm_drain import DrainSim
from simgrid_tpu_torch.parallel.campaign import Campaign

K = 16
FAT_TREE = """<?xml version='1.0'?>
<platform version="4.1">
  <zone id="world" routing="Full">
    <cluster id="ft" prefix="node-" radical="0-63" suffix=""
             speed="1Gf" bw="125MBps" lat="50us" topology="FAT_TREE"
             topo_parameters="2;8,8;1,2;1,1"/>
  </zone>
</platform>
"""


def build_fat_tree_drain(tmp_path, flows=400, seed=3):
    """Post `flows` seeded random-pair comms with tie-heavy sizes on the
    64-host fat tree, pay the latency phase, flatten the drain system."""
    path = os.path.join(tmp_path, "fat_tree64.xml")
    with open(path, "w") as f:
        f.write(FAT_TREE)
    s4u.Engine._reset()
    try:
        e = s4u.Engine(["drain", "--cfg=lmm/backend:list",
                        "--cfg=network/maxmin-selective-update:no",
                        "--cfg=network/optim:Full",
                        "--cfg=drain/fastpath:off"])
        e.load_platform(path)
        hosts = e.get_all_hosts()
        model = e.pimpl.network_model
        rng = np.random.default_rng(seed)
        pairs = rng.integers(0, len(hosts), size=(flows, 2))
        sizes = rng.choice(np.linspace(1e5, 2e6, 16), flows)
        actions = []
        for k in range(flows):
            src, dst = int(pairs[k, 0]), int(pairs[k, 1])
            if src == dst:
                dst = (dst + 1) % len(hosts)
            actions.append(model.communicate(hosts[src], hosts[dst],
                                             float(sizes[k]), -1.0))
        for _ in range(200):
            if all(a.variable is not None and a.variable.sharing_penalty > 0
                   for a in actions):
                break
            e.pimpl.surf_solve(-1.0)
        arrays, vars_in_order = lmm_jax.flatten(
            list(model.system.active_constraint_set))
        var_slot = {id(a.variable): k for k, a in enumerate(actions)}
        slot_flow = [var_slot[id(v)] for v in vars_in_order]
        rem = np.array([actions[f].get_remains_no_update()
                        for f in slot_flow])
        return arrays, rem
    finally:
        s4u.Engine._reset()


@pytest.fixture(scope="module")
def fat_tree(tmp_path_factory):
    return build_fat_tree_drain(str(tmp_path_factory.mktemp("ft")))


def make(cls, arrays, sizes, dtype, eps, **kw):
    E = arrays.n_elem
    return cls(arrays.e_var[:E], arrays.e_cnst[:E],
               arrays.e_w[:E].astype(dtype),
               arrays.c_bound[:arrays.n_cnst].astype(dtype), sizes,
               eps=eps, dtype=dtype, repack_min=kw.pop("repack_min", 64),
               **kw)


def bounds(arrays, variant):
    """The fixture's own LV08 penalties and rate bounds, or ("binding")
    the same bounds scaled by one factor, the median over flows of
    first solved rate / bound, so that about half of them bind.  The
    LV08 bounds take a few values (one per route length), and so do the
    scaled ones: tie groups of completions survive."""
    nv = arrays.n_var
    pen = arrays.v_penalty[:nv].astype(np.float64)
    vb = arrays.v_bound[:nv].astype(np.float64)
    if variant == "binding":
        rates = lmm_jax.solve_arrays(arrays, 1e-9)[0][:nv]
        vb = vb * np.median(rates / vb)
    return pen, vb


def to_np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def assert_same_drain(j, t):
    assert t.events == j.events
    assert t.t == j.t
    assert t.advances == j.advances
    assert t.supersteps == j.supersteps
    assert t.repacks == j.repacks


MODES = {
    "unfused64": (np.float64, 1e-9, {}, None),
    "fused64": (np.float64, 1e-9, dict(fused=True), None),
    "superstep64": (np.float64, 1e-9,
                    dict(superstep=K, superstep_rounds=K * 512), None),
    "superstep32": (np.float32, 1e-5,
                    dict(superstep=K, superstep_rounds=K * 512), None),
    # a tight JAX round budget (fused rescues after budget exits): the
    # device loop ends a slot's rounds at the budget, as JAX's does
    "superstep64_budget": (np.float64, 1e-9,
                           dict(superstep=K, superstep_rounds=40), True),
}


def assert_loop_rounds(j, t):
    """The rounds the loops ran (K16's tally, on the plain path the
    Python loops') are the rounds the control words report, and JAX's."""
    assert t.rounds == j.rounds
    assert device_tally()["lmm_round"] == t.rounds


@pytest.mark.parametrize("mode", list(MODES))
def test_drain_equals_jax(fat_tree, mode):
    arrays, sizes = fat_tree
    dtype, eps, kw, tight = MODES[mode]
    j = make(JaxDrainSim, arrays, sizes, dtype, eps, **kw)
    j.run()
    t = make(DrainSim, arrays, sizes, dtype, eps, device="cpu", **kw)
    reset_tally()
    t.run()
    assert_same_drain(j, t)
    assert len(t.events) == len(sizes)
    if kw.get("superstep"):
        assert t.repacks > 0          # K4's plain version ran
    if tight:
        assert_loop_rounds(j, t)


@pytest.mark.parametrize("variant", ["lv08", "binding"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bounded_drain_equals_jax(fat_tree, mode, variant):
    """The fixture's LV08 penalties and bounds (no bound binds), and the
    bounds redrawn to bind: every shape runs the bound arm."""
    arrays, sizes = fat_tree
    dtype, eps, kw, tight = MODES[mode]
    pen, vb = bounds(arrays, variant)
    kw = dict(kw, penalty=pen.astype(dtype), v_bound=vb.astype(dtype))
    j = make(JaxDrainSim, arrays, sizes, dtype, eps, **kw)
    j.run()
    t = make(DrainSim, arrays, sizes, dtype, eps, device="cpu", **kw)
    assert t.has_bounds and j.has_bounds
    reset_tally()
    t.run()
    assert_same_drain(j, t)
    assert len(t.events) == len(sizes)
    if kw.get("superstep"):
        assert t.repacks > 0          # K4 carried the bounds
    if tight:
        assert_loop_rounds(j, t)


def test_bounded_drain_repacks_twice_equals_jax(fat_tree):
    """The bounded superstep drain with its bounds redrawn to bind and a
    low repack floor, so that it halves its shapes at least twice (the
    bound rows carried each time: ``_drain_repack`` with
    ``_repack_vbound``), against the JAX drain."""
    arrays, sizes = fat_tree
    pen, vb = bounds(arrays, "binding")
    kw = dict(superstep=K, superstep_rounds=K * 512, penalty=pen,
              v_bound=vb, repack_min=8)
    j = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    j.run()
    t = make(DrainSim, arrays, sizes, np.float64, 1e-9, device="cpu",
             **kw)
    t.run()
    assert_same_drain(j, t)
    assert t.repacks >= 2


def _jax_repack(ev, ec, ew, pen, rem, thresh, ids, vb, vh, eh):
    """``_drain_repack`` with ``_repack_vbound``, as the JAX drain calls
    them (its element arrays in rows of 8)."""
    from simgrid_tpu.ops.lmm_drain import _drain_repack, _repack_vbound
    from simgrid_tpu.ops.lmm_jax import _pos_group
    out = _drain_repack(ev.reshape(-1, 8), ec.reshape(-1, 8),
                        ew.reshape(-1, 8), pen, rem, thresh, ids, vh=vh,
                        eh=eh, gv=_pos_group(len(pen)),
                        ge=_pos_group(len(ev)))
    return [np.asarray(x).reshape(-1) for x in out] + [
        np.asarray(_repack_vbound(vb, pen, vh=vh))]


@pytest.mark.parametrize("V", [600, 1003])
def test_livefirst_repack_plain_twice_equals_jax(V):
    """K4's plain version against ``_drain_repack`` and
    ``_repack_vbound``, twice in a row (the second from the first's
    halves, after more flows ended), every array by bits: the element
    arrays, the flow rows and the bound rows; the row indexes equal the
    ones built from the JAX halves."""
    import torch
    from simgrid_tpu_torch.kernels.livefirst_repack import \
        livefirst_repack_plain
    from simgrid_tpu_torch.ops.csr import build_csr
    from simgrid_tpu_torch.ops.lmm_torch import to_device_system
    rng = np.random.default_rng(V)
    E = -(-V * 3 // 8) * 8
    n_c = 40
    ev = np.sort(rng.integers(0, V, E)).astype(np.int32)
    ec = rng.integers(0, n_c, E).astype(np.int32)
    ew = np.where(rng.random(E) < 0.1, 0.0, rng.uniform(0.5, 1.5, E))
    pen = np.where(rng.random(V) < 0.4, rng.uniform(0.5, 2.0, V), 0.0)
    rem, thresh = rng.uniform(1e4, 1e6, V), rng.uniform(1, 10, V)
    ids = np.arange(V, dtype=np.int32)
    vb = np.where(rng.random(V) < 0.5, rng.uniform(1, 5, V), -1.0)
    cpu = torch.device("cpu")
    sys_ = to_device_system(ev, ec, ew, np.ones(n_c), V, torch.float64,
                            cpu)
    state = [torch.from_numpy(x) for x in (pen, rem, thresh, ids, vb)]
    for k in range(2):
        if k:      # flows end, so the live ones fit the next halving
            keep = np.arange(len(pen)) % 5 == 0
            pen = np.where(keep, pen, 0.0)
            state[0] = torch.from_numpy(pen)
        n_v = len(pen)
        vh, eh = n_v // 2, -(-(len(ev) // 2) // 8) * 8
        live_elems = int(((ew > 0) & (pen[ev] > 0)).sum())
        assert int((pen > 0).sum()) <= vh and live_elems <= eh
        want = _jax_repack(ev, ec, ew, pen, rem, thresh, ids, vb, vh, eh)
        rp = livefirst_repack_plain(sys_, *state[:4], vh, eh, live_elems,
                                    state[4])
        got = [rp.sys.e_var, rp.sys.e_cnst, rp.sys.e_w, rp.pen, rp.rem,
               rp.thresh, rp.ids, rp.vb]
        for g, w in zip(got, want):
            g = g.numpy()
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g.view(np.int64) if g.dtype == np.float64
                                  else g, w.view(np.int64)
                                  if w.dtype == np.float64 else w)
        csr = build_csr(*(torch.from_numpy(np.array(x)) for x in want[:3]),
                        n_c, vh)
        for g, w in zip(rp.sys.csr, csr):
            assert torch.equal(g, w)
        ev, ec, ew, pen, rem, thresh, ids, vb = want
        sys_, state = rp.sys, [rp.pen, rp.rem, rp.thresh, rp.ids, rp.vb]


def plan(cls, arrays, sizes, shape, **kw):
    """An engine-plan drain over the fixture's FULL padded arrays (the
    pow2 slack holds appended flows): LV08 penalties and bounds, flows
    0-9 still in their latency phase (penalty 0, bounded), absolute
    retirement at 1e-10, no repack."""
    nv, V = arrays.n_var, len(arrays.v_penalty)
    pen = np.zeros(V)
    pen[:nv] = arrays.v_penalty[:nv]
    pen[:10] = 0.0
    rem = np.zeros(V)
    rem[:nv] = sizes
    full = np.ones(V)
    full[:nv] = sizes
    return cls(arrays.e_var, arrays.e_cnst, arrays.e_w, arrays.c_bound,
               full, eps=1e-5, done_eps=1e-10, done_mode="abs",
               dtype=np.float64, v_bound=arrays.v_bound, penalty=pen,
               remains=rem, repack_min=1 << 62, **shape, **kw)


def transitions(arrays, rates):
    """A bound change on 5 live flows (redrawn to bind), a c_bound
    change on 3 links (as set_bandwidth gives it: 0.97 x the new
    bandwidth), the wake of flows 0-9 to their LV08 penalty, and a new
    flow in the first slack slot, on two links, in the first slack
    element slots."""
    nv, E = arrays.n_var, arrays.n_elem
    rng = np.random.default_rng(5)
    bslots = rng.choice(np.arange(10, nv), 5, replace=False)
    cslots = rng.choice(arrays.n_cnst, 3, replace=False)
    new = nv
    links = rng.choice(arrays.n_cnst, 2, replace=False)
    return {
        "v_bound": (np.append(bslots, new),
                    np.append(rates[bslots] * rng.uniform(0.5, 0.9, 5),
                              2e7)),
        "c_bound": (cslots, 0.97 * rng.uniform(5e7, 1.25e8, 3)),
        "v_penalty": (np.append(np.arange(10), new),
                      np.append(arrays.v_penalty[:10], 1.5e-4)),
        "e_var": (np.arange(E, E + 2), np.full(2, new)),
        "e_cnst": (np.arange(E, E + 2), links),
        "e_w": (np.arange(E, E + 2), np.array([1.0, 0.05])),
        "remains": ([new], [3e5]),
        "thresh": ([new], [1e-10]),
    }


def drive_plan(sim, arrays):
    """The engine-plan sequence: one superstep (or one advance), the
    rates, a transition batch, a partial advance by half the next dt,
    the rates again, then the drain to its end."""
    if sim.superstep_k:
        sim.superstep_batch()
    else:
        sim.advance()
    rates = np.asarray(sim.solve_rates())
    n = sim.apply_transitions(transitions(arrays, rates))
    rates2 = np.asarray(sim.solve_rates())
    pen, rem = to_np(sim._pen), to_np(sim._rem)
    flowing = (pen > 0) & (rates2 > 0)
    dt = np.min(rem[flowing] / rates2[flowing])
    done, n_live = sim.partial_advance(dt / 2)
    rates3 = np.asarray(sim.solve_rates())
    sim.run()
    return n, rates, rates2, rates3, np.asarray(done), n_live


def test_partial_advance_retires_like_jax(fat_tree):
    """A partial advance by the full next dt retires the flows the
    next advance would (strict <), on both sides."""
    arrays, sizes = fat_tree
    pen, vb = bounds(arrays, "binding")
    sims = [make(cls, arrays, sizes, np.float64, 1e-9, penalty=pen,
                 v_bound=vb, done_mode="abs", done_eps=1e-9, **kw)
            for cls, kw in ((JaxDrainSim, {}), (DrainSim,
                                                dict(device="cpu")))]
    outs = []
    for sim in sims:
        rates = np.asarray(sim.solve_rates())
        rem = to_np(sim._rem)
        flowing = rates > 0
        dt = np.min(rem[flowing] / rates[flowing])
        outs.append(sim.partial_advance(dt))
        outs.append((to_np(sim._pen).copy(), to_np(sim._rem).copy()))
    assert len(outs[0][0]) > 0
    np.testing.assert_array_equal(outs[0][0], outs[2][0])
    assert outs[0][1] == outs[2][1]
    for a, b in zip(outs[1], outs[3]):
        np.testing.assert_array_equal(a, b)


def test_transition_slot_out_of_range_raises():
    """A slot beyond its target raises before anything is scattered (the
    JAX program drops such an update; the kernel would write past the
    array)."""
    sim = DrainSim(np.zeros(8, np.int32), np.zeros(8, np.int32),
                   np.ones(8), np.ones(1), np.ones(1), dtype=np.float64,
                   device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        sim.apply_transitions({"c_bound": ([1], [2.0])})
    with pytest.raises(ValueError, match="out of range"):
        sim.apply_transitions({"v_bound": ([-1], [2.0])})
    assert sim.apply_transitions({"e_w": ([7], [0.5])}) == 1
    assert float(sim.sys.e_w[7]) == 0.5


def test_handover_mid_drain_equals_jax(fat_tree):
    """Run JAX for 3 supersteps, hand its committed state over through
    convert.py, finish in the port: the tail equals the all-JAX drain."""
    arrays, sizes = fat_tree
    kw = dict(superstep=K, superstep_rounds=K * 512)
    ref = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    ref.run()
    j = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    for _ in range(3):
        j.superstep_batch(k=K)
    assert 0 < len(j.events) < len(sizes)
    t = convert.resume_drain(convert.drain_state(j), eps=1e-9,
                             dtype=np.float64, repack_min=64,
                             device="cpu", **kw)
    t.run()
    assert_same_drain(ref, t)


def test_unported_options_raise():
    """``pipeline=D`` is ported (``tests/test_torch_pipeline.py``) and,
    as in JAX, needs ``superstep=K``; the engine capture is ported
    (``tests/test_torch_fastpath.py``) and, as in JAX, refuses a phase
    that is not a pure drain."""
    args = (np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones(1),
            np.ones(1), np.ones(1))
    with pytest.raises(ValueError, match="needs superstep"):
        DrainSim(*args, pipeline=2, device="cpu")

    class NotADrain:
        def capture_drain_scenario(self):
            return None

    with pytest.raises(RuntimeError, match="not a pure drain"):
        Campaign.from_engine(NotADrain(), [])


def test_handover_bounded_drain_equals_jax(fat_tree):
    """The same handover with binding bounds: the bound rows and the
    bound flag cross over through convert.py."""
    arrays, sizes = fat_tree
    pen, vb = bounds(arrays, "binding")
    kw = dict(superstep=K, superstep_rounds=K * 512, penalty=pen,
              v_bound=vb)
    ref = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    ref.run()
    j = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    for _ in range(3):
        j.superstep_batch(k=K)
    assert 0 < len(j.events) < len(sizes)
    state = convert.drain_state(j)
    assert state.has_bounds
    t = convert.resume_drain(state, eps=1e-9, dtype=np.float64,
                             repack_min=64, device="cpu",
                             superstep=K, superstep_rounds=K * 512)
    t.run()
    assert_same_drain(ref, t)


def test_port_handover_after_repack_equals_jax(fat_tree):
    """A port drain with binding bounds handed over to a fresh port
    drain (``convert.port_drain_state``, as the card hands over to the
    CPU) after its first device repack: the tail equals the all-JAX
    drain."""
    arrays, sizes = fat_tree
    pen, vb = bounds(arrays, "binding")
    kw = dict(superstep=K, superstep_rounds=K * 512, penalty=pen,
              v_bound=vb)
    ref = make(JaxDrainSim, arrays, sizes, np.float64, 1e-9, **kw)
    ref.run()
    t = make(DrainSim, arrays, sizes, np.float64, 1e-9, device="cpu", **kw)
    while t.repacks == 0:
        t.superstep_step()
    state = convert.port_drain_state(t)
    assert state.has_bounds and state.host is None
    assert len(state.pen) == t.n_v < len(sizes)
    u = convert.resume_drain(state, eps=1e-9, dtype=np.float64,
                             repack_min=64, device="cpu", superstep=K,
                             superstep_rounds=K * 512)
    u.run()
    assert_same_drain(ref, u)
