"""Collective schedule tapes against the host maestro: ``bench.py``'s
collective stage (``stage_collective``) on the port.

Each case compiles one allreduce (``CollectiveSpec.build``) and drains
it twice: the **tape** leg walks the whole DAG inside the superstep
(``DeviceCollective.make_sim(superstep=K)``, one dispatch per K
advances), the **maestro** leg replays the same recurrence one advance
per dispatch (``HostMaestro``).  The row carries ``bench.py``'s fields:
dispatches (the ``opstats`` delta, as ``bench.py`` reads it), uploaded
bytes and wall milliseconds per leg, the DAG's size, the activation
count, and whether the two legs' completions, activations and Kahan
clocks are equal bit for bit.

``CASES`` are the three recorded cases (``bench_results/
lmm_collective.jsonl``, superstep 8) and ``RECORDED`` their
platform-independent counts.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..collectives import CollectiveSpec, HostMaestro
from ..kernels import path_counts, reset_launch_counts
from ..kernels import superstep_loop as k16
from ..ops import opstats

SUPERSTEP = 8

#: bench.py's stage_collective cases: ring at 64 ranks, recursive
#: doubling at 256 and 1,024, all on per-rank NICs at 1e9 B/s
CASES = (CollectiveSpec("allreduce", "lr", 64, "nic", 1 << 17, bw=1e9),
         CollectiveSpec("allreduce", "rdb", 256, "nic", 1 << 20, bw=1e9),
         CollectiveSpec("allreduce", "rdb", 1024, "nic", 1 << 20, bw=1e9))

#: their counts in bench_results/lmm_collective.jsonl (superstep 8)
RECORDED = {
    ("lr", 64): dict(n_v=8128, n_edges=24128, activations=8064,
                     tape_dispatches=32, maestro_dispatches=632),
    ("rdb", 256): dict(n_v=2048, n_edges=7168, activations=1792,
                       tape_dispatches=2, maestro_dispatches=37),
    ("rdb", 1024): dict(n_v=10240, n_edges=36864, activations=9216,
                        tape_dispatches=3, maestro_dispatches=47),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_leg(dc, label: str, device: torch.device,
            superstep: int = SUPERSTEP, tape=None):
    """One leg (``"tape"`` or ``"maestro"``) of a compiled collective
    ``dc``, optionally under a fault tape.  Returns the executor (the
    tape drain or the maestro) and its record: dispatches, upload
    bytes, wall ms, launch counts, and the events, activations, fault
    events and clock."""
    before = opstats.snapshot()
    _sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    if label == "tape":
        ex = dc.make_sim(superstep=superstep, tape=tape, device=device)
        ex.run()
        _sync(device)
        clock = tuple(float(x) for x in ex._coll_clk.tolist())
        own = ex.supersteps
    elif label == "maestro":
        ex = HostMaestro(dc, tape=tape, device=device)
        ex.run()
        _sync(device)
        clock = ex.clock
        own = ex.dispatches
    else:
        raise ValueError(f"unknown leg {label!r} (tape or maestro)")
    wall = time.perf_counter() - t0
    st = opstats.diff(before)
    return ex, {
        "dispatches": int(st.get("dispatches", own)),
        "upload_bytes": int(st.get("uploaded_bytes_full", 0)
                            + st.get("uploaded_bytes_delta", 0)),
        "wall_ms": wall * 1e3, "launches": path_counts(),
        "loop": k16.summary(),
        "supersteps": ex.supersteps if label == "tape" else None,
        "events": ex.events, "collective_events": ex.collective_events,
        "fault_events": ex.fault_events, "clock": clock}


def same_legs(a: dict, b: dict) -> bool:
    """Completions, activations, fault events and the Kahan pair equal,
    bit for bit."""
    return all(a[k] == b[k] for k in ("events", "collective_events",
                                      "fault_events", "clock"))


def run_case(cs: CollectiveSpec, device: DeviceLike = None,
             superstep: int = SUPERSTEP
             ) -> Tuple[dict, Dict[str, dict], Dict[str, object]]:
    """Both legs of one case, as ``bench.py``'s stage runs them.
    Returns ``bench.py``'s row, each leg's record and each leg's
    executor."""
    device = resolve_device(device)
    dc = cs.build()
    legs, execs = {}, {}
    for label in ("tape", "maestro"):
        execs[label], legs[label] = run_leg(dc, label, device, superstep)
    row = {"bench": "lmm_collective", "op": cs.op, "algo": cs.algo,
           "ranks": cs.ranks, "topo": cs.topo, "payload": cs.payload,
           "superstep": superstep, "n_v": dc.n_v, "n_c": dc.n_c,
           "n_edges": dc.n_edges,
           "events_bit_identical": same_legs(legs["tape"],
                                             legs["maestro"]),
           "activations": len(legs["tape"]["collective_events"])}
    for label in ("tape", "maestro"):
        for k in ("dispatches", "upload_bytes", "wall_ms"):
            row[f"{label}_{k}"] = legs[label][k]
    row["dispatch_ratio"] = (row["maestro_dispatches"]
                             / max(row["tape_dispatches"], 1))
    return row, legs, execs


def recorded_mismatch(row: dict) -> Optional[str]:
    """None when the row's counts equal the recorded ones, else what
    differs."""
    want = RECORDED.get((row["algo"], row["ranks"]))
    if want is None:
        return None
    bad = {k: (row[k], v) for k, v in want.items() if row[k] != v}
    return f"{row['algo']} r{row['ranks']}: {bad}" if bad else None
