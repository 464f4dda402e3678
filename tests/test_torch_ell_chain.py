"""The port's ELL compaction chain (K8 rounds in K16's stage graphs, K9's
partitions) and ``solve_arrays``' layout choice and upload cache against
the JAX package's, on the CPU, compared as float64 bit patterns: chain
against chain, dense against dense, the stage-cap fallback, and the
headline class cut to 2,048 x 20,000.  The helpers are
``tests/test_torch_ell.py``'s (its docstring says how the row sums
fold); these tests live in a file of their own so that neither file
holds one worker of the tier-1 run too long.
"""

import numpy as np
import pytest

from simgrid_tpu.ops import lmm_jax
from simgrid_tpu.ops import opstats as jstats
from simgrid_tpu_torch.ops import lmm_ell, lmm_torch
from simgrid_tpu_torch.ops import opstats as pstats
from simgrid_tpu_torch.workloads import bench_solve
from test_torch_ell import jax_solve, same_result


# ---------------------------------------------------------------------------
# the compaction chain


def chain_arrays(seed=13):
    """tests/test_lmm.py's chain system: 4,096 constraints, 33,000
    variables of degree 3 (65,536 variable slots: three stages)."""
    return bench_solve.build_arrays(np.random.default_rng(seed), 4096,
                                    33000, 3, np.float64)


def test_chain_and_dense_equal_jax():
    a = chain_arrays()
    before = pstats.snapshot()
    p_chain = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain="on")
    d = pstats.diff(before)
    assert d.get("ell_chain_solves") == 1 and not d.get("ell_solves")
    j_chain = jax_solve(a, 1e-9, "ell", "on")
    assert same_result(p_chain, j_chain)
    p_dense = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                                     chain="off")
    j_dense = jax_solve(a, 1e-9, "ell", "off")
    assert same_result(p_dense, j_dense)
    # JAX's own chain/dense agreement (test_lmm.py), held by the port too
    assert p_chain[3] == p_dense[3]


def test_chain_stage_cap_overflow_falls_back(monkeypatch):
    """A stage cap of 1 overflows the first stage: the chain returns
    None and the dense path re-solves, equal to JAX's same fallback."""
    a = chain_arrays(17)
    monkeypatch.setattr(lmm_ell, "_CHAIN_STAGE_CAP", 1)
    monkeypatch.setattr(lmm_jax, "_CHAIN_STAGE_CAP", 1)
    before = pstats.snapshot()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="ell",
                               chain="on")
    d = pstats.diff(before)
    assert d.get("ell_chain_fallbacks") == 1 and d.get("ell_solves") == 1
    j = jax_solve(a, 1e-9, "ell", "on")
    assert same_result(p, j)
    assert same_result(p, jax_solve(a, 1e-9, "ell", "off"))


# ---------------------------------------------------------------------------
# solve_arrays: the layout choice and the upload cache


def test_layout_auto_on_cpu_stays_coo():
    a = chain_arrays()
    before = pstats.snapshot()
    p = lmm_torch.solve_arrays(a, 1e-9, device="cpu")
    d = pstats.diff(before)
    assert not d.get("ell_solves") and not d.get("ell_chain_solves")
    assert same_result(p, jax_solve(a, 1e-9, "auto", "auto"))
    with pytest.raises(ValueError):
        lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout="csr")


@pytest.mark.parametrize("layout,chain", [("ell", "off"), ("ell", "on"),
                                          ("coo", "auto")])
def test_uploaded_bytes_equal_jax(layout, chain):
    """The first solve uploads what JAX uploads (its upload kinds and
    arrays), a repeated solve of the same arrays nothing (a cache hit)."""
    a = chain_arrays(21)
    got, want = [], []
    for _ in range(2):
        pb, jb = pstats.snapshot(), jstats.snapshot()
        lmm_torch.solve_arrays(a, 1e-9, device="cpu", layout=layout,
                               chain=chain)
        jax_solve(a, 1e-9, layout, chain)
        got.append(pstats.diff(pb).get("uploaded_bytes_full", 0))
        want.append(jstats.diff(jb).get("uploaded_bytes_full", 0))
    assert got == want and got[0] > 0 and got[1] == 0


def test_headline_reduced_equals_jax():
    """bench.py's headline class cut to 2,048 x 20,000 (degree 4, seed
    42): the chain (run_bench_solve's default path on an accelerator)
    against JAX's chain, and the dense path against JAX's."""
    kw = dict(n_c=2048, n_v=20_000, deg=4, seed=42, device="cpu", reps=1,
              layout="ell")
    a = bench_solve.build_arrays(np.random.default_rng(42), 2048, 20_000, 4,
                                 np.float64)
    for chain in ("on", "off"):
        res, row = bench_solve.run_bench_solve(chain=chain, **kw)
        assert row["path"] == ("chain" if chain == "on" else "dense")
        assert same_result(res, jax_solve(a, 1e-9, "ell", chain))
