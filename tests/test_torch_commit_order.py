"""The order a superstep commit logs one advance's events in, port
against the JAX package, on the CPU, bit for bit (tolerance 0).

Within one advance the ring holds the completions in slot order, then
the fault-tape entry, then the activations in slot order.  Small
hand-made drains put several of each into single advances: flows that
complete together, a fault date that ties the planned dt, a fault date
that ties an activation date, and several activations due exactly at
the advance's event date.  Every date is exact in binary, so the
expected events are written out as well as held against JAX's.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from simgrid_tpu.ops.lmm_drain import DrainSim as JaxDrainSim
from simgrid_tpu_torch.kernels import common as kc
from simgrid_tpu_torch.kernels.common import (COMMIT_HEAD, COMMIT_TILE,
                                              Work, commit_tiles, inf_key)
from simgrid_tpu_torch.ops.lmm_drain import DrainSim

K = 4

# ---------------------------------------------------------------------------
# completions together, a fault that ties the planned dt
# ---------------------------------------------------------------------------

#: six flows, one link each at 1e6: flows 1 and 5 end at 2.0 together,
#: flows 0, 2 and 3 at 5.0 together; the tape halves link 4 at 2.0 and
#: restores it at 5.0, both dates tying the advance's planned dt
TAPE_SIZES = np.array([5e6, 2e6, 5e6, 5e6, 8e6, 2e6])
TAPE = (np.array([2.0, 5.0]), np.array([4, 4], np.int32),
        np.array([5e5, 1e6]))
TAPE_EVENTS = [(2.0, 1), (2.0, 5), (5.0, 0), (5.0, 2), (5.0, 3), (9.5, 4)]


def tape_sim(cls, dtype):
    kw = dict(device="cpu") if cls is DrainSim else {}
    n = len(TAPE_SIZES)
    return cls(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
               np.ones(n, dtype), np.full(n, 1e6, dtype), TAPE_SIZES,
               eps=1e-9, dtype=dtype, superstep=K, tape=TAPE, **kw)


@pytest.fixture(scope="module", params=[np.float64, np.float32],
                ids=["f64", "f32"])
def tape_runs(request):
    out = []
    for cls in (JaxDrainSim, DrainSim):
        s = tape_sim(cls, request.param)
        s.run()
        out.append(s)
    return out


def test_completions_together_then_the_fault_equal_jax(tape_runs):
    j, p = tape_runs
    assert p.events == j.events == TAPE_EVENTS
    assert p.fault_events == j.fault_events == [(2.0, 4), (5.0, 4)]
    assert p.t == j.t == 9.5


def test_tape_drain_counters_equal_jax(tape_runs):
    j, p = tape_runs
    assert (p.advances, p.supersteps, p.rounds) \
        == (j.advances, j.supersteps, j.rounds)
    # one advance a distinct date: the ties share their advance
    assert p.advances == 3


# ---------------------------------------------------------------------------
# a collective: a fault that ties activations, activations due together
# ---------------------------------------------------------------------------

#: six flows, one link each at 1e6.  Flow 0 ends at 1.0 and frees flows
#: 2 and 3 after 0.5; flow 4 waits for its date 1.5: three activations
#: due exactly at 1.5, where the tape also doubles link 5.  Flows 1 and
#: 4 end at 2.0 together, where a tape entry ties the planned dt; flows
#: 2 and 3 at 2.5 together; flow 2 frees flow 5 after 0.25 (2.75, with a
#: tape entry on the same date), which ends at 3.25 on its doubled link.
COLL_SIZES = np.array([1e6, 2e6, 1e6, 1e6, 5e5, 1e6])
COLL = (np.array([0, 0, 1, 1, 0, 1], np.int32),
        np.array([np.inf, np.inf, np.inf, np.inf, 1.5, np.inf]),
        np.array([0, 0, 2], np.int32), np.array([2, 3, 5], np.int32),
        np.array([0.0, 0.0, 0.5, 0.5, 0.0, 0.25]))
COLL_TAPE = (np.array([1.5, 2.0, 2.75]), np.array([5, 0, 2], np.int32),
             np.array([2e6, 5e5, 5e5]))
COLL_EVENTS = [(1.0, 0), (2.0, 1), (2.0, 4), (2.5, 2), (2.5, 3),
               (3.25, 5)]


@pytest.fixture(scope="module")
def coll_runs():
    n = len(COLL_SIZES)
    out = []
    for cls in (JaxDrainSim, DrainSim):
        kw = dict(device="cpu") if cls is DrainSim else {}
        s = cls(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
                np.ones(n), np.full(n, 1e6), COLL_SIZES, eps=1e-9,
                dtype=np.float64, superstep=K,
                penalty=np.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]),
                collective=COLL, tape=COLL_TAPE, **kw)
        s.run()
        out.append(s)
    return out


def test_fault_tied_with_activations_equal_jax(coll_runs):
    j, p = coll_runs
    assert p.events == j.events == COLL_EVENTS
    assert p.collective_events == j.collective_events \
        == [(1.5, 2), (1.5, 3), (1.5, 4), (2.75, 5)]
    assert p.fault_events == j.fault_events \
        == [(1.5, 5), (2.0, 0), (2.75, 2)]
    assert p.t == j.t == 3.25


def test_collective_clock_and_counters_equal_jax(coll_runs):
    j, p = coll_runs
    assert p._coll_clk.tolist() == np.asarray(j._coll_clk).tolist()
    assert (p.advances, p.supersteps, p.rounds) \
        == (j.advances, j.supersteps, j.rounds)


# ---------------------------------------------------------------------------
# the Work state K2 and K3 keep between calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_work_holds_inf_minima_and_commit_scratch(dtype, B):
    """K2's minimum slots start at the bits of +inf (each call's last
    block resets them so), and K3's scratch row fits the tile counts of
    ``n_v`` flags."""
    n_v = 2 * COMMIT_TILE + 1
    w = Work(n_v, 5, dtype, torch.device("cpu"), B=B)
    lead = () if B is None else (B,)
    assert w.dtbits.shape == lead + (1,) and w.atbits.shape == lead + (1,)
    inf = torch.tensor([float("inf")], dtype=dtype)
    assert bool((w.dtbits == int(inf.view(
        torch.int64 if dtype == torch.float64 else torch.int32))).all())
    assert bool((w.atbits == int(torch.tensor(
        [float("inf")], dtype=torch.float64).view(torch.int64))).all())
    assert inf_key(dtype) == int(w.dtbits.reshape(-1)[0])
    assert commit_tiles(n_v) == 3 and commit_tiles(0) == 1
    assert w.commit_scan.shape == lead + (COMMIT_HEAD + 6,)
    assert w.commit_scan.dtype == torch.int32


# ---------------------------------------------------------------------------
# the slots and sizes the CUDA sources and the Python side both declare
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "simgrid_tpu_torch" / "csrc"


def csrc_defines(*names):
    """``#define NAME value`` of the given sources, each value evaluated
    after the names defined before it."""
    out = {}
    for name in names:
        for m in re.finditer(r"^#define (\w+) (.+)$",
                             (CSRC / name).read_text(), re.M):
            expr = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)u\b", r"\1",
                          m.group(2).split("//")[0])
            out[m.group(1)] = eval(expr, {}, dict(out))
    return out


#: the Python name of a C slot or size where it is not the C name less
#: its ``C_`` prefix
PY_NAME = {"F_TSUM": "T_SUM", "F_TCOMP": "T_COMP", "F_DT": "DT"}
LAYOUT = {k: v for k, v in csrc_defines("common.cuh").items()
          if k != "FULL_MASK"}
#: K11's packed payload: its part numbers and alignment
LAYOUT.update(csrc_defines("fleet_payload.cuh"))
LAYOUT.update({k: v for k, v in csrc_defines("superstep_commit.cu").items()
               if k in ("COMMIT_TILE", "COMMIT_HEAD")})
#: every other value a ``.cu`` source defines, as ``source:NAME``, held
#: to its twin in the source's wrapper (``kernels/<source>.py``)
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))
#: twins under another name than the C one
TWIN = {
    "transition_scatter.cu:KIND_I32": lambda m: m._KIND[torch.int32],
    "transition_scatter.cu:KIND_F32": lambda m: m._KIND[torch.float32],
    "transition_scatter.cu:KIND_F64": lambda m: m._KIND[torch.float64],
    "transition_scatter.cu:KIND_BOOL": lambda m: m._KIND[torch.bool],
    "transition_scatter.cu:KIND_POS": lambda m: m._KIND_POSITIVE,
}
#: values only the kernel reads (its threads a block, loads a thread,
#: the slots of its own scratch): no Python side to match
INTERNAL = {"ell_chain.cu:ST_TB", "ell_chain.cu:ROW_IPT",
            "ell_chain.cu:ENT_IPT", "lmm_round.cu:LPV",
            "probe_scan.cu:SEQ_BATCH", "superstep_commit.cu:COMMIT_TB",
            "warm_init.cu:FOLD_WINDOWS",
            *(f"superstep_commit.cu:{n}" for n in (
                "CS_NEV", "CS_FLAGS", "CS_TN", "CS_OK", "CS_FFIRE",
                "CS_AANY"))}
DEFINES = {f"{src}:{n}": v for src in SOURCES
           for n, v in csrc_defines(src).items()}
LAYOUT.update({k: v for k, v in DEFINES.items() if k not in INTERNAL
               and k.split(":")[1] not in LAYOUT})


def _twin(src: str, name: str):
    mod = importlib.import_module("simgrid_tpu_torch.kernels."
                                  + src[:-len(".cu")])
    key = f"{src}:{name}"
    return TWIN[key](mod) if key in TWIN else getattr(mod, name)


@pytest.mark.parametrize("c_name", sorted(LAYOUT))
def test_csrc_layout_matches_python(c_name):
    """Every ctrl/fctrl/evf slot (K1's launch-wide ticket among them),
    flag, K3 scratch size and K11 payload part of the CUDA sources equals
    its twin in ``kernels/common.py``, and every other value a ``.cu`` source
    defines (pointer counts, arm flags, loop conditions, tile sizes,
    payload kinds) its twin in the source's wrapper."""
    if ":" in c_name:
        src, name = c_name.split(":")
        assert _twin(src, name) == LAYOUT[c_name]
        return
    py = PY_NAME.get(c_name, c_name[2:] if c_name.startswith("C_")
                     else c_name)
    assert getattr(kc, py) == LAYOUT[c_name]


def test_kernel_internal_defines_are_listed():
    """The values no Python code mirrors are each defined by their
    source, and every define of every ``.cu`` source is held above or
    listed as internal."""
    assert INTERNAL <= set(DEFINES)
    held = {k for k in LAYOUT if ":" in k} | {
        f"superstep_commit.cu:{n}" for n in ("COMMIT_TILE", "COMMIT_HEAD")}
    assert set(DEFINES) == held | INTERNAL
