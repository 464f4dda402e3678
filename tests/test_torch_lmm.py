"""The port's max-min solve (simgrid_tpu_torch.ops.lmm_torch) against the
JAX package's, on the CPU: values, remaining capacities, usages and
round counts must be equal (==), not close, in every arm of the
fixpoint (local and global rounds, bounds, FATPIPE constraints).

Inputs are seeded numpy draws in the style of bench.py's random systems
and of the exact-solver property tests (tests/test_lmm.py), handed to
both sides as numpy arrays.
"""

import numpy as np
import pytest
import torch

from simgrid_tpu.ops import lmm_jax
from simgrid_tpu_torch import convert
from simgrid_tpu_torch.kernels.common import IT, LIGHT, Work
from simgrid_tpu_torch.kernels.lmm_round import lmm_init_plain, \
    lmm_round_plain
from simgrid_tpu_torch.ops import lmm_torch
from simgrid_tpu_torch.ops.lmm_arrays import bucket

EPS = 1e-9


def random_arrays(seed, n_c, n_v, deg, dtype=np.float64, pad=0):
    """A random system: each variable on `deg` random constraints with
    weights in [0.5, 1.5], bounds in [1, 10], padded to pow2 buckets
    (plus `pad` extra slots of each kind)."""
    rng = np.random.default_rng(seed)
    E = n_v * deg
    Eb, Cb, Vb = bucket(E) + pad, bucket(n_c) + pad, bucket(n_v) + pad
    e_var = np.zeros(Eb, np.int32)
    e_cnst = np.zeros(Eb, np.int32)
    e_w = np.zeros(Eb, dtype)
    e_var[:E] = np.repeat(np.arange(n_v, dtype=np.int32), deg)
    e_cnst[:E] = rng.integers(0, n_c, size=E).astype(np.int32)
    e_w[:E] = rng.uniform(0.5, 1.5, size=E).astype(dtype)
    c_bound = np.zeros(Cb, dtype)
    c_bound[:n_c] = rng.uniform(1.0, 10.0, size=n_c).astype(dtype)
    v_penalty = np.zeros(Vb, dtype)
    v_penalty[:n_v] = 1.0
    return lmm_jax.LmmArrays(e_var, e_cnst, e_w, c_bound,
                             np.zeros(Cb, bool), v_penalty,
                             np.full(Vb, -1.0, dtype), E, n_c, n_v)


def mixed_arrays(seed, n_c, n_v, p_bound, p_fat, dtype=np.float64):
    """A system mixing rate bounds, penalties and FATPIPE constraints,
    drawn like tests/test_lmm.py's ``_random_system``: capacities in
    [1, 100], a share ``p_fat`` of FATPIPE constraints, a share
    ``p_bound`` of variables bounded in [0.5, 50], penalties from
    {0.5, 1, 1, 2, 3}, 1-5 distinct constraints per variable with
    weights from {0.5, 1, 1, 2}; padded to pow2 buckets."""
    rng = np.random.default_rng(seed)
    c_cap = rng.uniform(1, 100, n_c)
    fat = rng.random(n_c) < p_fat
    bound = np.where(rng.random(n_v) < p_bound,
                     rng.uniform(0.5, 50, n_v), -1.0)
    penalty = rng.choice([0.5, 1.0, 1.0, 2.0, 3.0], n_v)
    n_links = rng.integers(1, min(5, n_c) + 1, n_v)
    e_cnst = np.concatenate([rng.choice(n_c, size=k, replace=False)
                             for k in n_links])
    E = len(e_cnst)
    Eb, Cb, Vb = bucket(E), bucket(n_c), bucket(n_v)
    arrays = lmm_jax.LmmArrays(
        np.zeros(Eb, np.int32), np.zeros(Eb, np.int32), np.zeros(Eb, dtype),
        np.zeros(Cb, dtype), np.zeros(Cb, bool), np.zeros(Vb, dtype),
        np.full(Vb, -1.0, dtype), E, n_c, n_v)
    arrays.e_var[:E] = np.repeat(np.arange(n_v), n_links)
    arrays.e_cnst[:E] = e_cnst
    arrays.e_w[:E] = rng.choice([0.5, 1.0, 1.0, 2.0], E)
    arrays.c_bound[:n_c] = c_cap
    arrays.c_fatpipe[:n_c] = fat
    arrays.v_penalty[:n_v] = penalty
    arrays.v_bound[:n_v] = bound
    return arrays


def assert_same_solve(arrays, eps=EPS, parallel_rounds=True):
    jv, jr, ju, jrounds = lmm_jax.solve_arrays(
        arrays, eps, parallel_rounds=parallel_rounds)
    tv, tr, tu, trounds = lmm_torch.solve_arrays(
        convert.lmm_arrays(arrays), eps, device="cpu",
        parallel_rounds=parallel_rounds)
    assert trounds == jrounds
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(tu, np.asarray(ju))


@pytest.mark.parametrize("seed,n_c,n_v,deg", [
    (0, 40, 150, 3), (1, 400, 2500, 4), (2, 1500, 9000, 5)])
def test_random_systems_equal_jax(seed, n_c, n_v, deg):
    assert_same_solve(random_arrays(seed, n_c, n_v, deg))


def test_padded_slots_equal_jax():
    assert_same_solve(random_arrays(3, 100, 700, 3, pad=37))


def test_zero_bound_constraint_equal_jax():
    a = random_arrays(4, 120, 800, 3)
    a.c_bound[[0, 5, 17]] = 0.0
    assert_same_solve(a)


def test_disabled_variables_equal_jax():
    a = random_arrays(5, 120, 800, 3)
    rng = np.random.default_rng(55)
    a.v_penalty[rng.choice(800, 200, replace=False)] = 0.0
    a.v_penalty[:50] = 2.0            # and a few non-unit penalties
    assert_same_solve(a)


def test_float32_equal_jax():
    assert_same_solve(random_arrays(6, 300, 2000, 4, np.float32), eps=1e-5)


#: the (seed, n_c, n_v, p_bound, p_fat) matrix of tests/test_lmm.py's
#: test_round_modes_match_oracle_large
MATRIX = [(10, 100, 300, 0.0, 0.0), (11, 100, 300, 0.8, 0.0),
          (12, 100, 300, 0.0, 0.8), (13, 150, 400, 0.5, 0.5),
          (14, 60, 600, 0.3, 0.2)]


@pytest.mark.parametrize("parallel_rounds", [True, False],
                         ids=["local", "global"])
@pytest.mark.parametrize("seed,n_c,n_v,p_bound,p_fat", MATRIX)
def test_bound_fatpipe_matrix_equals_jax(seed, n_c, n_v, p_bound, p_fat,
                                         parallel_rounds):
    """Every arm of the fixpoint in float64 at the engine's eps: the
    bound-first rule, the FATPIPE usage max, local and global rounds."""
    assert_same_solve(mixed_arrays(seed, n_c, n_v, p_bound, p_fat), 1e-5,
                      parallel_rounds)


@pytest.mark.parametrize("parallel_rounds", [True, False],
                         ids=["local", "global"])
def test_bound_fatpipe_float32_equals_jax(parallel_rounds):
    assert_same_solve(mixed_arrays(13, 150, 400, 0.5, 0.5, np.float32),
                      1e-5, parallel_rounds)


def test_disabled_bounded_variable_keeps_bound_arm_off():
    """A bound on a disabled variable does not switch the bound arm on
    (the host decision masks it by penalty > 0, as JAX's does)."""
    a = random_arrays(9, 30, 90, 2)
    a.v_penalty[4] = 0.0
    a.v_bound[4] = 0.25
    assert_same_solve(a)


@pytest.mark.parametrize("parallel_rounds", [True, False],
                         ids=["local", "global"])
@pytest.mark.parametrize("n_rounds", [1, 2, 5])
def test_plain_round_all_arms_equals_jax_fixpoint(n_rounds,
                                                  parallel_rounds):
    """K1's plain version with every arm on (bounds, FATPIPE), init + n
    rounds, against the JAX fixpoint stopped after n rounds."""
    a = mixed_arrays(13, 150, 400, 0.5, 0.5)
    eps = 1e-5
    carry = lmm_jax.fixpoint(
        a.e_var, a.e_cnst, a.e_w, a.c_bound, a.c_fatpipe, a.v_penalty,
        a.v_bound, eps, len(a.c_bound), len(a.v_penalty),
        parallel_rounds=parallel_rounds, max_rounds=n_rounds,
        return_carry=True, has_bounds=True, has_fatpipe=True)[4]
    cpu = torch.device("cpu")
    sys = lmm_torch.to_device_system(a.e_var, a.e_cnst, a.e_w, a.c_bound,
                                     len(a.v_penalty), torch.float64, cpu,
                                     a.c_fatpipe)
    pen = torch.from_numpy(a.v_penalty.copy())
    vb = torch.from_numpy(a.v_bound.copy())
    w = Work(len(a.v_penalty), len(a.c_bound), torch.float64, cpu)
    lmm_init_plain(sys, w, pen, eps, has_fatpipe=True)
    for _ in range(n_rounds):
        assert lmm_round_plain(sys, w, pen, eps, vb, has_bounds=True,
                               has_fatpipe=True,
                               global_rounds=not parallel_rounds)
    for name, j in zip(("v_value", "v_fixed", "remaining", "usage",
                        "light"), carry[:5]):
        np.testing.assert_array_equal(getattr(w, name).numpy(),
                                      np.asarray(j), err_msg=name)
    assert int(w.ctrl[IT]) == int(carry[5]) == n_rounds
    assert int(w.ctrl[LIGHT]) == int(np.count_nonzero(carry[4]))


@pytest.mark.parametrize("n_rounds", [1, 2, 5])
def test_plain_round_equals_jax_fixpoint_rounds(n_rounds):
    """K1's plain version, init + n rounds, against the JAX fixpoint
    stopped after n rounds (the drain's specialisation)."""
    a = random_arrays(7, 200, 1200, 4)
    carry = lmm_jax.fixpoint(
        a.e_var, a.e_cnst, a.e_w, a.c_bound, a.c_fatpipe, a.v_penalty,
        a.v_bound, EPS, len(a.c_bound), len(a.v_penalty),
        parallel_rounds=True, max_rounds=n_rounds, return_carry=True,
        has_bounds=False, has_fatpipe=False)[4]
    sys = lmm_torch.to_device_system(a.e_var, a.e_cnst, a.e_w, a.c_bound,
                                     len(a.v_penalty), torch.float64,
                                     torch.device("cpu"))
    pen = torch.from_numpy(a.v_penalty.copy())
    w = Work(len(a.v_penalty), len(a.c_bound), torch.float64,
             torch.device("cpu"))
    lmm_init_plain(sys, w, pen, EPS)
    for _ in range(n_rounds):
        assert lmm_round_plain(sys, w, pen, EPS)
    for name, j in zip(("v_value", "v_fixed", "remaining", "usage",
                        "light"), carry[:5]):
        np.testing.assert_array_equal(getattr(w, name).numpy(),
                                      np.asarray(j), err_msg=name)
    assert int(w.ctrl[IT]) == int(carry[5]) == n_rounds
    assert int(w.ctrl[LIGHT]) == int(np.count_nonzero(carry[4]))


def test_pointer_cache_keys_bound_free_arms_without_bounds(monkeypatch):
    """K1's pointer cache (``lmm_round._ptrs``): the init and a
    bound-free round share one entry whether or not the caller passes
    rate bounds; the bound arm keys on the bounds it reads."""
    from simgrid_tpu_torch.kernels import lmm_round as k1
    built = []
    monkeypatch.setattr(k1, "ptr_array",
                        lambda ts: built.append(list(ts)) or object())
    a = convert.lmm_arrays(random_arrays(3, 20, 40, 3))
    sys = lmm_torch.to_device_system(a.e_var, a.e_cnst, a.e_w, a.c_bound,
                                     len(a.v_penalty), torch.float64, "cpu")
    w = Work(len(a.v_penalty), len(a.c_bound), torch.float64, "cpu")
    pen = torch.ones(len(a.v_penalty), dtype=torch.float64)
    vb = torch.full_like(pen, 2.0)
    free = k1._ptrs(sys, w, pen, None, 0)
    assert k1._ptrs(sys, w, pen, vb, 0) is free
    bounded = k1._ptrs(sys, w, pen, vb, k1.ARM_BOUNDS)
    assert bounded is not free
    assert k1._ptrs(sys, w, pen, vb, k1.ARM_BOUNDS) is bounded
    assert len(built) == 2 and built[0][1] is None and built[1][1] is vb
    with pytest.raises(ValueError, match="rate bounds"):
        k1._ptrs(sys, w, pen, None, k1.ARM_BOUNDS | k1.ARM_FATPIPE)
