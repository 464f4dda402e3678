#!/usr/bin/env python3
"""The op-cost probe of the PyTorch port on the CUDA card: P1-P8 of the
TPU tools and their op-cost table on the hand-written kernels K12-K15
(``simgrid_tpu_torch.probes.opcost.run_opcost``), then per-element
against per-op cost (``simgrid_tpu_torch.probes.scaling.run_scaling``).

Prints the card's name and power limit, then one JSON line per probe row
(probe, name, arm, dtype, ms, enqueue_us, bound_ms, max_abs_err, ok,
library, library_ms, ...), then one summary line.  With ``--out PATH``
it also appends the rows to PATH (``bench_results/torch_opcost.jsonl``
by convention); it writes nothing else.  Exits 1 if a row failed its
check.

Usage:
  python tools/torch_opcost.py [--device cuda|cpu] [--scale 1.0]
         [--out PATH]

``--device cpu --scale 0.0625`` runs the plain versions on the host
(host-timer times, no bound: not device numbers).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out).startswith("tpu_"):
        ap.error("the TPU tools' records (bench_results/tpu_*.jsonl) are "
                 "not the port's: pick another --out")
    from simgrid_tpu_torch.device import resolve_device
    from simgrid_tpu_torch.probes.opcost import run_opcost
    from simgrid_tpu_torch.probes.scaling import run_scaling
    dev = resolve_device(args.device)
    smi = card() if dev.type == "cuda" else "cpu"
    print(smi, flush=True)
    t0 = time.perf_counter()
    runs = [run_opcost(dev, args.scale), run_scaling(dev, args.scale)]
    wall = time.perf_counter() - t0
    stamp = {"card": smi, "scale": args.scale, "ts": round(time.time(), 1)}
    rows = [{**row, **stamp} for r in runs for row in r["rows"]]
    for row in rows:
        print(json.dumps(row), flush=True)
    ok = all(r["ok"] for r in runs)
    print(json.dumps({"ok": ok, "rows": len(rows), "wall_s": wall,
                      "sync_ms": runs[0]["sync_ms"],
                      "device": runs[0]["device"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
