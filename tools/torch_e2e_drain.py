#!/usr/bin/env python3
"""End-to-end config-#4 drain on the PyTorch port (simgrid_tpu_torch).

Builds a config-#4 system on the 65,536-host dragonfly with the port's
generator (``--workload random``: ``--flows`` random flows, unit
penalties, no bounds; ``random-lv08``: the same flows with the penalty
and rate bound the LV08 engine gives each; ``alltoall``: the ``--ranks``
alltoall with its LV08 values, 102,080 flows at 320 ranks) and drains it
with the port's
DrainSim on the CUDA card, once per requested executor shape, printing
one JSON row each (advances, rounds, supersteps, syncs, repacks, wall
seconds, t_sim, kernel launch counts) after a line with the card's name
and power limit.  The drain is ``workloads.drain_run.run_drain``, the
same one ``chip_smoke.py`` times as its main path; ``--engine-plan``
drives ``drain_run.run_engine_plan`` instead (latency lanes, one
transition batch, one partial advance; superstep shape only; an LV08
workload), and
``--solve`` adds one timed ``drain_run.run_solve`` of the system.

Usage:
  python tools/torch_e2e_drain.py [--workload random|random-lv08|alltoall]
         [--flows 100000] [--ranks 320] [--dtype float64]
         [--modes superstep16,fused,unfused] [--done-mode rel|abs]
         [--engine-plan [--max-advances N]] [--solve] [--profile]
         [--out FILE.jsonl]

``--profile`` runs each drain once more under torch.profiler and adds
the device time per kernel (summed over the drain), the total device
time and the device busy share (device time over the profiled wall) to
the row.

Run it on the card (it imports nothing of the JAX package).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile(make) -> dict:
    """One more drain under torch.profiler: device microseconds per
    kernel name, their total, and the busy share of the profiled wall."""
    import torch
    from torch.profiler import ProfilerActivity
    sim = make()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            name = re.split(r"[<(]", name)[0] or ev.name
            d = per.setdefault(name, [0, 0.0])
            d[0] += 1
            d[1] += ev.time_range.elapsed_us()
    total_us = sum(v[1] for v in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:20]
    return dict(wall_s=wall, device_us=total_us,
                busy_share=total_us / (wall * 1e6),
                kernels={k: dict(n=v[0], us=v[1]) for k, v in top})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="random",
                    choices=["random", "random-lv08", "alltoall"])
    ap.add_argument("--flows", type=int, default=100_000)
    ap.add_argument("--ranks", type=int, default=320)
    ap.add_argument("--engine-plan", action="store_true")
    ap.add_argument("--max-advances", type=int, default=None,
                    help="engine plan: advances past the partial advance "
                         "(default: to the end)")
    ap.add_argument("--solve", action="store_true")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--modes", default="superstep16",
                    help="comma list of superstepK, fused, unfused")
    ap.add_argument("--done-mode", default=None, choices=["rel", "abs"],
                    help="default: abs for an LV08 workload (the "
                         "engine plan's rule), else rel")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    lv08 = args.workload != "random"
    if args.engine_plan and not lv08:
        ap.error("--engine-plan drives an LV08 workload "
                 "(random-lv08 or alltoall)")

    import torch
    from simgrid_tpu_torch.kernels import build
    from simgrid_tpu_torch.workloads import dragonfly
    from simgrid_tpu_torch.workloads.drain_run import (make_sim, run_drain,
                                                       run_engine_plan,
                                                       run_solve)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    # build and load every kernel library before any timed region
    for name in build.SOURCES:
        build.load(name)
    t0 = time.perf_counter()
    if args.workload == "alltoall":
        sys_ = dragonfly.build_alltoall(args.ranks)
    else:
        sys_ = dragonfly.build_system(args.flows, lv08=lv08)
    build_s = time.perf_counter() - t0
    rows = []
    base = dict(card=smi, build_s=build_s, workload=args.workload,
                lv08=lv08)
    if args.solve:
        _, solved = run_solve(sys_, device=dev, dtype=args.dtype)
        rows.append(dict(base, mode="solve", **solved))
        print(json.dumps(rows[-1]), flush=True)
    if args.engine_plan:
        sim, planned, _ = run_engine_plan(sys_, device=dev,
                                          max_advances=args.max_advances)
        rows.append(dict(base, mode="engine_plan", **planned))
        print(json.dumps(rows[-1]), flush=True)
        del sim
    for mode in ([] if args.engine_plan else args.modes.split(",")):
        kw = dict(device=dev, dtype=args.dtype, done_mode=args.done_mode)
        if mode.startswith("superstep"):
            kw["superstep"] = int(mode[len("superstep"):])
        elif mode == "fused":
            kw["fused"] = True
        elif mode != "unfused":
            raise SystemExit(f"unknown mode {mode!r}")
        sim, drained = run_drain(sys_, **kw)
        row = dict(base, mode=mode, dtype=args.dtype,
                   done_mode=sim.done_mode, **drained)
        if args.profile:
            row["profile"] = profile(lambda: make_sim(sys_, **kw))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del sim
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
