"""K15: K dependent gather rounds on the device, and P8's ``x * 2``.

Replaces P3 ``tools/tpu_pallas_probe.py`` ``lk`` (``:105``): from
``acc = zeros(8)``, each of ``rounds`` rounds gathers the whole
``tab + acc[0] * 1e-30`` at ``idx [V, DEG]`` into ``g`` and adds
``g[:8, 0]`` to ``acc``; the result is ``acc`` as ``[8, 1]``, as ``lk``
writes it.  ``lk``'s ``g.sum(axis=1)[:8] * 0`` adds an exact zero and
is left out.  And P8 ``tools/tpu_opcost.py`` ``pk`` (``:166``):
:func:`probe_double`.  The CUDA source is ``csrc/probe_loop.cu``.

Arms of the loop (ROADMAP A11's question: how the solver's fixpoint
loop goes onto the device; the ``cond`` arm is the mechanism K16 runs
the port's loops on), every one writing the whole ``g`` each
round and equal to the plain loop by bits:

* ``coop``: all rounds in one cooperative launch, grid-wide syncs
  between the gather and the update and between rounds (counted under
  ``probe_loop_coop``); a grid larger than the co-resident maximum is
  refused by the launch and raises;
* ``launch``: one launch per round (``probe_loop_launch``, once per
  launch);
* ``graph``: the per-round launches captured once in a
  ``torch.cuda.CUDAGraph`` (:class:`LoopGraph`) and replayed.  Captured
  launches run only when the graph replays, so capture counts nothing;
  each replay counts once under ``probe_loop_graph``;
* ``cond``: one round captured once into the body of a CUDA-graph
  conditional WHILE node (K16, :class:`CondLoop`), whose condition node
  counts the rounds; each launch of the graph runs every round and
  counts once under ``superstep_loop_probe``.

:func:`probe_double` counts under ``probe_double``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import superstep_loop as k16
from .common import I, L, P, check, counter, is_double, on_cpu, ptr, stream

ARMS = ("coop", "launch", "graph", "cond")
COUNTS = {a: counter(f"probe_loop_{a}") for a in ARMS if a != "cond"}
COUNTS["cond"] = k16.COUNTS["probe"]
DOUBLE_COUNT = counter("probe_double")
#: the rounds of P3's ``lk`` (``K_ROUNDS``)
ROUNDS = 16

_SIG = {"probe_loop_coop": [I, I, L, I, I, P, P, P, P, P],
        "probe_loop_round": [I, I, L, I, P, P, P, P, P, P],
        "probe_loop_round_at": [I, L, I, P, P, P, P, P, P],
        "probe_loop_coop_grid": [I, P],
        "probe_double": [I, L, P, P, P]}


def probe_loop_plain(tab: torch.Tensor, idx: torch.Tensor,
                     rounds: int = ROUNDS) -> torch.Tensor:
    flat = idx.reshape(-1).long()
    deg = idx.shape[-1]
    tiny = torch.tensor(1e-30, dtype=tab.dtype, device=tab.device)
    acc = torch.zeros(8, dtype=tab.dtype, device=tab.device)
    for _ in range(rounds):
        g = (tab + acc[0] * tiny)[flat]
        acc = acc + g.reshape(-1, deg)[:8, 0]
    return acc.reshape(8, 1)


def probe_double_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def _check_args(tab: torch.Tensor, idx: torch.Tensor, rounds: int) -> None:
    if tab.dim() != 1 or idx.dim() != 2 or idx.dtype != torch.int32:
        raise TypeError("probe_loop takes a 1-D table and an int32 index "
                        "[V, DEG]")
    if idx.shape[0] < 8 or rounds < 0:
        raise ValueError("probe_loop needs V >= 8 rows and rounds >= 0")


def coop_grid(dtype: torch.dtype) -> int:
    """The coop arm's grid: its co-resident maximum on the current card."""
    lib = build.load("probe_loop", _SIG)
    out = ctypes.c_int(0)
    check(lib.probe_loop_coop_grid(is_double(dtype), ctypes.byref(out)),
          "probe_loop_coop_grid")
    return int(out.value)


def _rounds(tab, idx, g, accs, rounds) -> None:
    """``rounds`` launches of the one-round kernel; ``accs`` [2, 8] are
    the two acc buffers (round k reads row k % 2, writes the other)."""
    lib = build.load("probe_loop", _SIG)
    dbl, n, deg = is_double(tab.dtype), idx.numel(), int(idx.shape[1])
    capturing = torch.cuda.is_current_stream_capturing()
    for k in range(rounds):
        rc = lib.probe_loop_round(dbl, int(k == 0), n, deg, ptr(tab),
                                  ptr(idx), ptr(g), ptr(accs[k % 2]),
                                  ptr(accs[(k + 1) % 2]), stream())
        check(rc, "probe_loop (launch)")
        if not capturing:
            COUNTS["launch"].n += 1


class LoopGraph:
    """The ``graph`` arm: the per-round launches for these inputs,
    captured once (after one uncaptured run, which loads the kernel and
    counts under ``probe_loop_launch``) and replayed by :meth:`replay`."""

    def __init__(self, tab: torch.Tensor, idx: torch.Tensor,
                 rounds: int = ROUNDS):
        _check_args(tab, idx, rounds)
        if on_cpu(tab, idx):
            raise ValueError("a CUDA graph needs CUDA tensors")
        if rounds < 1:
            raise ValueError("a LoopGraph runs at least one round")
        self.tab, self.idx, self.rounds = tab, idx, rounds
        self.g = torch.empty(idx.numel(), dtype=tab.dtype, device=tab.device)
        self.accs = torch.zeros((2, 8), dtype=tab.dtype, device=tab.device)
        _rounds(tab, idx, self.g, self.accs, rounds)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _rounds(tab, idx, self.g, self.accs, rounds)

    def replay(self) -> torch.Tensor:
        """Run every round; the result ([8, 1]) is a view of the graph's
        own buffer, overwritten by the next replay."""
        self.graph.replay()
        COUNTS["graph"].n += 1
        return self.accs[self.rounds % 2].view(8, 1)


class CondLoop:
    """The ``cond`` arm: one graph whose conditional WHILE node runs the
    round ``rounds`` times (the count word says which round it is), built
    at the first :meth:`replay`."""

    def __init__(self, tab: torch.Tensor, idx: torch.Tensor,
                 rounds: int = ROUNDS):
        _check_args(tab, idx, rounds)
        if on_cpu(tab, idx):
            raise ValueError("a CUDA graph needs CUDA tensors")
        self.rounds = rounds
        dev = tab.device
        self.g = torch.empty(idx.numel(), dtype=tab.dtype, device=dev)
        self.accs = torch.zeros((2, 8), dtype=tab.dtype, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        lib = build.load("probe_loop", _SIG)
        args = (is_double(tab.dtype), idx.numel(), int(idx.shape[1]),
                ptr(tab), ptr(idx), ptr(self.g), ptr(self.accs), ptr(cnt))

        def one_round():
            check(lib.probe_loop_round_at(*args, stream()),
                  "probe_loop (cond)")
        self.loop = k16.DeviceLoop(
            [k16.Loop(k16.PRED_COUNT, None, (one_round,), cap=rounds,
                      cnt=cnt, tally="probe")],
            "probe", dev, refs=(tab, idx))

    def replay(self) -> torch.Tensor:
        """Run every round; the result ([8, 1]) is a view of the graph's
        own buffer, overwritten by the next replay."""
        self.loop.run()
        return self.accs[self.rounds % 2].view(8, 1)


def probe_loop(tab: torch.Tensor, idx: torch.Tensor, rounds: int = ROUNDS,
               arm: str = "coop", grid: int = 0) -> torch.Tensor:
    """``lk``'s result ([8, 1]) after ``rounds`` rounds.  ``grid`` sets
    the coop arm's blocks (0: :func:`coop_grid`).  The graph arm captures
    a :class:`LoopGraph` and replays it once; keep a :class:`LoopGraph`
    to replay it many times."""
    if arm not in ARMS:
        raise ValueError(f"probe_loop arm {arm!r} not in {ARMS}")
    _check_args(tab, idx, rounds)
    if on_cpu(tab, idx):
        return probe_loop_plain(tab, idx, rounds)
    if arm == "graph" and rounds:
        return LoopGraph(tab, idx, rounds).replay().clone()
    if arm == "cond" and rounds:
        return CondLoop(tab, idx, rounds).replay().clone()
    g = torch.empty(idx.numel(), dtype=tab.dtype, device=tab.device)
    if arm != "coop":     # the launch arm, or a graph of no round
        accs = torch.zeros((2, 8), dtype=tab.dtype, device=tab.device)
        _rounds(tab, idx, g, accs, rounds)
        return accs[rounds % 2].reshape(8, 1)
    acc = torch.empty(8, dtype=tab.dtype, device=tab.device)
    lib = build.load("probe_loop", _SIG)
    rc = lib.probe_loop_coop(is_double(tab.dtype), rounds, idx.numel(),
                             int(idx.shape[1]), grid, ptr(tab), ptr(idx),
                             ptr(g), ptr(acc), stream())
    check(rc, "probe_loop (coop; a grid above the co-resident maximum "
              "is refused)")
    COUNTS["coop"].n += 1
    return acc.reshape(8, 1)


def probe_double(x: torch.Tensor) -> torch.Tensor:
    """P8's ``x * 2``."""
    if on_cpu(x):
        return probe_double_plain(x)
    out = torch.empty_like(x)
    lib = build.load("probe_loop", _SIG)
    rc = lib.probe_double(is_double(x.dtype), x.numel(), ptr(x), ptr(out),
                          stream())
    check(rc, "probe_double")
    DOUBLE_COUNT.n += 1
    return out
