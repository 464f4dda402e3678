"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/simgrid_tpu_torch/<name>-<hash>.so`` (all sources in parallel,
one nvcc each), with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -fmad=false -shared -Xcompiler -fPIC

``-fmad=false`` keeps nvcc from contracting ``a*b+c`` into an FMA: the
drain pins the rounding of ``rate*dt`` on its own (``_rounded_product``
in the JAX package), and the in-order sums must round every add.  The
hash covers the sources, the shared headers and the flags, so a changed
source rebuilds and an unchanged one loads what is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "simgrid_tpu_torch")
SOURCES = ("lmm_round", "drain_advance", "superstep_commit",
           "livefirst_repack", "transition_scatter", "warm_init",
           "ell_round", "vc_round", "ell_chain", "dag_walk",
           "fleet_materialize", "probe_gather", "probe_segsum",
           "probe_scan", "probe_loop", "superstep_loop")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-prec-div=true", "-shared", "-Xcompiler",
         "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "simgrid_tpu_torch build from source at first "
                           "use and need the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith(".cuh") or fn == name + ".cu":
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False
              ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Compile every source that has no up-to-date library.  Returns
    name -> library path, and name -> compiler output of the sources
    compiled now (``verbose`` adds ``-Xptxas -v``: registers, shared
    memory and spills per kernel)."""
    extra = ["-Xptxas", "-v"] if verbose else []
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: os.path.join(BUILD_DIR, f"{n}-{_digest(n)}.so")
             for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    logs: Dict[str, str] = {}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = paths[n] + f".tmp{os.getpid()}"
            cmd = [nvcc, *FLAGS, *extra, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, n + ".cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            out, _ = p.communicate()
            logs[n] = out
            if p.returncode != 0:
                failed.append(f"--- {n}.cu ---\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths, logs


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library of one source (built on first use), with the
    argument types of its C entries declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths, _ = build_all()
            for n, path in paths.items():
                _libs[n] = ctypes.CDLL(path)
            lib = _libs[name]
    if signatures:
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            if f.argtypes is None:
                f.argtypes = argtypes
                f.restype = ctypes.c_int
    return lib
