"""The port's host layer (simgrid_tpu_torch.ops.lmm_host, lmm_view and
lmm_torch.flatten) against the JAX package's, on the CPU.

Both packages' Systems are built and mutated through the same seeded
calls; the list solver's results (bit for bit, as float64 bit
patterns), the ArrayView's arrays, counters and dirty-index maps, and
the flattened arrays must be equal, not close.
"""

import numpy as np
import pytest

from simgrid_tpu.ops import SharingPolicy as JSharing
from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops import make_new_maxmin_system as jax_system
from simgrid_tpu.ops.lmm_view import ArrayView as JView
from simgrid_tpu_torch.ops import lmm_torch
from simgrid_tpu_torch.ops.lmm_host import LmmFlags
from simgrid_tpu_torch.ops.lmm_host import SharingPolicy as PSharing
from simgrid_tpu_torch.ops.lmm_host import make_new_maxmin_system
from simgrid_tpu_torch.ops.lmm_view import ArrayView as PView
from simgrid_tpu_torch.workloads import churn

SIDES = {"jax": (jax_system, JSharing, JView),
         "port": (make_new_maxmin_system, PSharing, PView)}

VIEW_FIELDS = ("e_var", "e_cnst", "e_w", "c_bound", "c_fatpipe",
               "v_penalty", "v_bound")


def random_system(side, seed, n_cnst, n_var, selective, p_bound=0.3,
                  p_fat=0.2):
    """tests/test_lmm.py's ``_random_system``, on either package."""
    make, sharing, _ = SIDES[side]
    rng = np.random.default_rng(seed)
    s = make(selective)
    cnsts = [s.constraint_new(None, float(rng.uniform(1, 100)))
             for _ in range(n_cnst)]
    for c in cnsts:
        if rng.random() < p_fat:
            c.sharing_policy = sharing.FATPIPE
    variables = []
    for _ in range(n_var):
        bound = float(rng.uniform(0.5, 50)) if rng.random() < p_bound \
            else -1.0
        penalty = float(rng.choice([0.5, 1.0, 1.0, 2.0, 3.0]))
        n_links = int(rng.integers(1, min(5, n_cnst) + 1))
        var = s.variable_new(None, penalty, bound, n_links)
        for ci in rng.choice(n_cnst, size=n_links, replace=False):
            s.expand(cnsts[int(ci)], var,
                     float(rng.choice([0.5, 1.0, 1.0, 2.0])))
        variables.append(var)
    return s, cnsts, variables, rng


def as_bits(a):
    """An array's values as a list, floats as their bit patterns."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.view(f"i{a.itemsize}")
    return a.tolist()


def host_state(s):
    """The host state as float64 bit patterns: ``==`` on them is
    equality bit for bit (-0.0 differs from 0.0, a NaN equals itself)."""
    return tuple(a.view(np.int64).tolist() for a in churn.host_state(s))


@pytest.mark.parametrize("selective", [False, True],
                         ids=["full", "selective"])
@pytest.mark.parametrize("seed,shape", [(0, (3, 6)), (1, (10, 25)),
                                        (2, (25, 80)), (3, (40, 200))])
def test_list_solver_equals_jax(seed, shape, selective):
    """``solve_exact`` on both Systems, then after a round of mutations
    (bounds, penalties, frees, new flows) once more."""
    runs = {side: random_system(side, seed, *shape, selective)
            for side in SIDES}
    for step in range(2):
        for side, (s, cnsts, variables, rng) in runs.items():
            if step:
                s.update_constraint_bound(cnsts[0], 7.5)
                s.update_variable_penalty(variables[1], 2.5)
                s.update_variable_bound(variables[-1], 0.75)
                s.variable_free(variables.pop(2))
                v = s.variable_new(None, 1.0, -1.0, 1)
                s.expand(cnsts[-1], v, 2.0)
            s.solve_exact()
        assert host_state(runs["port"][0]) == host_state(runs["jax"][0])


def build_both(side):
    make, _, view_cls = SIDES[side]
    s = make(False)
    view_cls(s)
    return s


def view_state(view, consumer):
    d = view.consume(consumer)
    dirty = None if d is None else {
        f: (True if d[f] is True else sorted(d[f])) for f in VIEW_FIELDS}
    return ([as_bits(getattr(view, f)) for f in VIEW_FIELDS],
            view.n_elem, view.dead_elems, view.version, view.layout_epoch,
            dirty)


def test_view_churn_stress_equals_jax():
    """The churn stress of tests/test_lmm_view_churn.py (create, free,
    expand_add, bound and penalty updates, forced compaction, f64/f32
    handout alternation) on both packages: after every step the view's
    arrays, counters, dirty-index map and snapshot are equal, and so is
    ``flatten`` of the constraint list."""
    runs = {}
    for side in SIDES:
        s = build_both(side)
        runs[side] = (s, np.random.default_rng(123), [], [])
    dtypes = [np.float64, np.float32]
    for step in range(120):
        for side, (s, rng, cnsts, variables) in runs.items():
            sharing = SIDES[side][1]
            op = rng.random()
            if op < 0.22 or len(cnsts) < 2:
                c = s.constraint_new(None, float(rng.uniform(1, 100)))
                if rng.random() < 0.3:
                    c.sharing_policy = sharing.FATPIPE
                cnsts.append(c)
            elif op < 0.50:
                bound = float(rng.uniform(0.5, 50)) \
                    if rng.random() < 0.4 else -1.0
                v = s.variable_new(None, float(rng.choice([0.5, 1.0, 2.0])),
                                   bound, 3)
                for ci in rng.choice(len(cnsts), size=min(3, len(cnsts)),
                                     replace=False):
                    s.expand(cnsts[int(ci)], v,
                             float(rng.choice([0.5, 1.0, 2.0])))
                variables.append(v)
            elif op < 0.62 and variables:
                s.variable_free(
                    variables.pop(int(rng.integers(len(variables)))))
            elif op < 0.74 and variables:
                v = variables[int(rng.integers(len(variables)))]
                if v.cnsts:
                    s.expand_add(v.cnsts[0].constraint, v,
                                 float(rng.choice([0.5, 1.0])))
            elif op < 0.86 and cnsts:
                s.update_constraint_bound(
                    cnsts[int(rng.integers(len(cnsts)))],
                    float(rng.uniform(1, 100)))
            elif variables:
                v = variables[int(rng.integers(len(variables)))]
                if rng.random() < 0.5:
                    s.update_variable_bound(v, float(rng.uniform(0.5, 50)))
                else:
                    s.update_variable_penalty(
                        v, float(rng.choice([0.0, 0.5, 1.0, 2.0])))
            if step % 13 == 12:
                s.array_view._compact()
        (js, *_), (ps, *_) = runs["jax"], runs["port"]
        assert view_state(ps.array_view, "t") == \
            view_state(js.array_view, "t"), f"step {step}"
        dt = dtypes[step % 2]
        jsnap, psnap = js.array_view.snapshot(dt), ps.array_view.snapshot(dt)
        for a, b in zip(psnap, jsnap):
            assert as_bits(a) == as_bits(b)
        jf = lmm_jax.flatten(list(js.constraint_set), dt)
        pf = lmm_torch.flatten(list(ps.constraint_set), dt)
        assert (jf is None) == (pf is None)
        if jf is not None:
            for a, b in zip(pf[0], jf[0]):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                assert as_bits(a) == as_bits(b)
            assert [v.rank for v in pf[1]] == [v.rank for v in jf[1]]


@pytest.mark.parametrize("side", list(SIDES))
def test_view_census_and_expected_frees(side):
    """tests/test_lmm_view_churn.py's census checks on both packages: one
    version bump per mutation event, expected frees skip the bump but
    still mark dirty slots, consume maps reset per call and an epoch
    bump loses index identity."""
    make, sharing, view_cls = SIDES[side]
    s = make(False)
    view = view_cls(s)
    v0 = view.version
    c = s.constraint_new(None, 10.0)
    v = s.variable_new(None, 1.0)
    s.expand(c, v, 1.0)
    s.update_constraint_bound(c, 5.0)
    s.update_variable_bound(v, 2.0)
    c.sharing_policy = sharing.FATPIPE
    assert view.version == v0 + 6
    assert view.consume("w") is None
    s.update_constraint_bound(c, 4.0)
    d = view.consume("w")
    assert d["c_bound"] == {c._view_slot} and not d["e_w"]
    ver = view.version
    view.expected_frees.add(id(v))
    s.variable_free(v)
    assert view.version == ver
    d = view.consume("w")
    assert d["e_w"] and d["v_penalty"]
    epoch = view.layout_epoch
    view._compact()
    assert view.layout_epoch == epoch + 1
    assert view.consume("w")["e_w"] is True


def test_flags_validate_and_carry_reference_defaults():
    f = LmmFlags()
    assert (f.precision, f.concurrency_limit, f.backend, f.threshold,
            f.dtype, f.rounds, f.warm_start, f.delta_upload, f.strict) == \
        (1e-5, -1, "auto", 512, "float64", "local", "auto", "auto", False)
    with pytest.raises(ValueError, match="backend"):
        LmmFlags(backend="jax")
    s = make_new_maxmin_system(False, LmmFlags(concurrency_limit=3,
                                               precision=1e-9))
    assert s.constraint_new(None, 1.0).concurrency_limit == 3
    assert s.flags.precision == 1e-9


def test_install_backends():
    """``list`` keeps the host list solver; the device backends need a
    card unless the caller asks for the CPU; ``auto`` sends small live
    sets to the list solver."""
    import torch
    s = make_new_maxmin_system(True)
    lmm_torch.install(s, LmmFlags(backend="list"))
    assert s.solve_fn is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lmm_torch.install(s, LmmFlags(backend="torch"))
    lmm_torch.install(s, LmmFlags(backend="auto"), device="cpu")
    c = s.constraint_new(None, 4.0)
    for _ in range(3):
        s.expand(c, s.variable_new(None, 1.0), 1.0)
    s.solve()
    assert s.warm_solver is None          # 3 < 512: the list solver
    assert [v.value for v in s.variable_set] == [4.0 / 3] * 3
