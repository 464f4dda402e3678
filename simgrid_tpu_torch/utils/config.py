"""Typed configuration/flag registry of the port.

The port's own copy of ``simgrid_tpu/utils/config.py`` (the reference's
xbt config, src/xbt/config.cpp, with the flag declarations of
src/simgrid/sg_config.cpp:258-437): typed flags with defaults, aliases,
on-set callbacks, ``--cfg=key:value`` command-line parsing and a
``help-cfg`` dump.  It declares the flags that the port's modules read,
under the JAX package's names and with its defaults, so that a user's
``--cfg=`` lines carry over.  ``lmm/backend`` takes ``torch`` (the
device solve), ``auto`` (the host list solver below
``lmm/jax-threshold`` live variables, the device above) or ``list``;
:func:`lmm_flags` reads the solver flags into the
:class:`~simgrid_tpu_torch.ops.lmm_host.LmmFlags` that every model's
System is installed with.
"""

from __future__ import annotations

import contextlib
import logging
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional

_log = logging.getLogger("simgrid_tpu_torch.xbt_cfg")


class ConfigError(Exception):
    pass


class _Flag:
    __slots__ = ("name", "description", "default", "value", "type", "callback",
                 "aliases", "touched")

    def __init__(self, name: str, description: str, default: Any,
                 callback: Optional[Callable[[Any], None]] = None,
                 aliases: Optional[List[str]] = None):
        self.name = name
        self.description = description
        self.default = default
        self.value = default
        self.type = type(default)
        self.callback = callback
        self.aliases = aliases or []
        # Explicit-set tracking (the reference's isdefault flag,
        # config.cpp:141,171,240): an explicit set that happens to equal the
        # default still counts as touched.
        self.touched = False


_TRUTHY = {"yes", "on", "true", "1"}
_FALSY = {"no", "off", "false", "0"}


class Config:
    """A registry of typed flags (the equivalent of simgrid's sg_cfg_*)."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._alias: Dict[str, str] = {}

    # -- declaration ------------------------------------------------------
    def declare(self, name: str, description: str, default: Any,
                callback: Optional[Callable[[Any], None]] = None,
                aliases: Optional[List[str]] = None) -> None:
        if name in self._flags:
            # Re-declaration keeps the already-set value (mirrors the
            # reference's idempotent module registration).
            return
        flag = _Flag(name, description, default, callback, aliases)
        self._flags[name] = flag
        for a in flag.aliases:
            self._alias[a] = name

    # -- access -----------------------------------------------------------
    def _resolve(self, name: str) -> _Flag:
        name = self._alias.get(name, name)
        try:
            return self._flags[name]
        except KeyError:
            raise ConfigError(f"Unknown configuration key '{name}' "
                              f"(try help-cfg for the list)") from None

    def get(self, name: str) -> Any:
        return self._resolve(name).value

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any) -> None:
        flag = self._resolve(name)
        if isinstance(value, str) and flag.type is not str:
            value = self._parse(flag, value)
        elif flag.type is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, flag.type) and not (flag.type is float and isinstance(value, int)):
            raise ConfigError(f"Invalid value {value!r} for flag '{flag.name}' "
                              f"of type {flag.type.__name__}")
        # the callback validates: a refused value leaves the flag as it was
        if flag.callback is not None:
            flag.callback(value)
        flag.value = value
        flag.touched = True

    def __setitem__(self, name: str, value: Any) -> None:
        self.set(name, value)

    def is_default(self, name: str) -> bool:
        return not self._resolve(name).touched

    def set_default(self, name: str, value: Any) -> None:
        """Change the default (and the value if never explicitly set) — the
        reference's config::set_default used by model initializers."""
        flag = self._resolve(name)
        if not flag.touched:
            self.set(name, value)        # validates the type first
            flag.touched = False         # still counts as a default
        flag.default = value

    @staticmethod
    def _parse(flag: _Flag, text: str) -> Any:
        if flag.type is bool:
            low = text.lower()
            if low in _TRUTHY:
                return True
            if low in _FALSY:
                return False
            raise ConfigError(f"Invalid boolean '{text}' for flag '{flag.name}'")
        if flag.type is int:
            return int(text)
        if flag.type is float:
            return float(text)
        return text

    # -- command line -----------------------------------------------------
    def set_from_string(self, opt: str) -> None:
        """Parse a --cfg= payload: one ``key:value``, or several
        space-separated ones (the reference accepts
        --cfg='a:x b:y c:z')."""
        # A payload with spaces is a multi-option list ONLY if every
        # token's text before its first ':' names a DECLARED flag —
        # otherwise the whole payload is one value that happens to
        # contain spaces and colons (a path list, a URL).
        tokens = [opt]
        if " " in opt:
            parts = opt.split()
            def _known(tok: str) -> bool:
                key = tok.split(":", 1)[0].strip()
                return key in self._flags or key in self._alias
            if all(":" in t and _known(t) for t in parts):
                tokens = parts
        for token in tokens:
            if ":" not in token:
                raise ConfigError(
                    f"Invalid --cfg option '{token}', expected key:value")
            key, value = token.split(":", 1)
            self.set(key.strip(), value.strip())
            # reference simgrid::config logs every CLI change
            _log.info(
                "Configuration change: Set '%s' to '%s'"
                % (key.strip(), value.strip()))

    def parse_argv(self, argv: List[str]) -> List[str]:
        """Consume --cfg=... / --log=... / --help-cfg from argv,
        returning the rest.  ``--log=`` controls are consumed and
        ignored: the port logs through the standard ``logging`` module
        (logger ``simgrid_tpu_torch.xbt_cfg``)."""
        remaining: List[str] = []
        for arg in argv:
            if arg.startswith("--cfg="):
                self.set_from_string(arg[len("--cfg="):])
            elif arg.startswith("--log="):
                pass
            elif arg == "--help-cfg":
                self.dump(sys.stdout)
            else:
                remaining.append(arg)
        return remaining

    def dump(self, out) -> None:
        for name in sorted(self._flags):
            f = self._flags[name]
            out.write(f"   {name}: {f.description} (default: {f.default!r})\n")

    @contextlib.contextmanager
    def scoped(self) -> Iterator["Config"]:
        """Within the block, flags may be set freely: every value,
        default and explicit-set mark is restored on exit (an engine's
        ``--cfg`` lines and its models' ``set_default`` calls
        included)."""
        saved = {name: (f.value, f.default, f.touched)
                 for name, f in self._flags.items()}
        try:
            yield self
        finally:
            for name, (value, default, touched) in saved.items():
                f = self._flags[name]
                f.value, f.default, f.touched = value, default, touched


#: Process-wide configuration registry (mirrors simgrid_config).
config = Config()


def declare_flag(name: str, description: str, default: Any,
                 callback: Optional[Callable[[Any], None]] = None,
                 aliases: Optional[List[str]] = None) -> None:
    config.declare(name, description, default, callback, aliases)


#: Process-wide configuration registry (mirrors simgrid_config).
config = Config()


def declare_flag(name: str, description: str, default: Any,
                 callback: Optional[Callable[[Any], None]] = None,
                 aliases: Optional[List[str]] = None) -> None:
    config.declare(name, description, default, callback, aliases)


def _choice(name: str, allowed) -> Callable[[Any], None]:
    def check(value) -> None:
        if value not in allowed:
            raise ConfigError(f"Invalid value {value!r} for flag '{name}' "
                              f"(expected one of {', '.join(allowed)})")
    return check


# ---------------------------------------------------------------------------
# The flags the port reads, with the JAX package's names and defaults
# (simgrid_tpu/utils/config.py, from the reference's sg_config.cpp).
# ---------------------------------------------------------------------------
declare_flag("maxmin/precision",
             "Numerical precision used when updating simulation variables",
             1e-5, aliases=["maxmin/epsilon"])
declare_flag("surf/precision",
             "Numerical precision used when comparing simulated times",
             1e-5)
declare_flag("maxmin/concurrency-limit",
             "Maximum number of concurrent variables per resource (-1: none)",
             -1)
declare_flag("host/model", "Host model to use", "default")
declare_flag("cpu/model", "CPU model to use", "Cas01")
declare_flag("network/model", "Network model to use", "LV08")
declare_flag("storage/model", "Storage model to use", "default")
declare_flag("cpu/optim", "CPU optimization mode (Lazy/TI/Full)", "Lazy")
declare_flag("network/optim", "Network optimization mode (Lazy/Full)", "Lazy")
declare_flag("cpu/maxmin-selective-update",
             "Update the constraint set selectively for CPU", False)
declare_flag("network/maxmin-selective-update",
             "Update the constraint set selectively for network", False)
declare_flag("network/crosstraffic",
             "Model cross-traffic (bidirectional flows interfere)", True)
declare_flag("network/TCP-gamma",
             "Maximum TCP window size (bytes)", 4194304.0)
# Global defaults come from the LV08 model (sg_config.cpp:270-279); the
# plain CM02 init resets them to 1.0/1.0/0.0.
declare_flag("network/latency-factor",
             "Multiplier for link latencies", 13.01)
declare_flag("network/bandwidth-factor",
             "Multiplier for link bandwidths", 0.97)
declare_flag("network/weight-S",
             "RTT cost correction added per link (LV08: 20537)", 20537.0)
declare_flag("network/loopback-bw", "Default loopback bandwidth", 498000000.0)
declare_flag("network/loopback-lat", "Default loopback latency", 0.000015)
declare_flag("lmm/backend",
             "Max-min solver backend: list (exact host list solver), "
             "torch (the device solve), auto (the list solver below "
             "lmm/jax-threshold live variables, the device above)", "auto",
             callback=_choice("lmm/backend", ("torch", "auto", "list")))
declare_flag("lmm/jax-threshold",
             "Minimum live variable count before 'auto' switches the solve "
             "to the device", 512)
declare_flag("lmm/dtype", "Device solver dtype: float64 or float32",
             "float64",
             callback=_choice("lmm/dtype", ("float64", "float32")))
declare_flag("lmm/layout",
             "Device solver element layout: coo, ell, or auto (ell on the "
             "card where the width and fill caps accept the system)",
             "auto")
declare_flag("lmm/rounds",
             "Saturation-round strategy: global (one bottleneck level per "
             "round) or local (every local-minimum constraint per round)",
             "local")
declare_flag("lmm/chain",
             "Compaction chain of the ELL solve: on, off, or auto (on the "
             "card for large ELL solves)", "auto")
declare_flag("lmm/warm-start",
             "Selective-update solves on the device: off (re-flatten the "
             "modified subset), cold (resident arrays, cold restart), "
             "on/auto (warm-started restarts of the modified component)",
             "auto")
declare_flag("lmm/delta-upload",
             "Ship System mutations to the resident solver arrays as one "
             "indexed payload per solve: on, off, or auto", "auto")
declare_flag("lmm/strict",
             "Raise on a failed device solve on the host CPU path instead "
             "of handing it to the exact host solver", False)
declare_flag("drain/fastpath",
             "Delegate pure-drain phases (every started flow past its "
             "latency phase, no deadlines, no profile event before the "
             "next completion) to the device superstep executor: auto/on "
             "require a torch or auto lmm/backend and at least "
             "drain/min-flows started flows; off disables the fast path",
             "auto")
declare_flag("drain/superstep",
             "Advances per superstep in the drain fast path", 16)
declare_flag("drain/min-flows",
             "Minimum started network flows before the drain fast path "
             "engages", 4096)
declare_flag("drain/pipeline",
             "Speculative supersteps in flight in the drain fast path (it "
             "keeps one whenever this is > 0); results are those of 0 by "
             "bits", 1)
declare_flag("drain/transitions",
             "Absorb recognizable transitions (latency wakes, new flows on "
             "existing routes, bound/weight/penalty changes, partial "
             "advances) into a live drain plan: auto/on, or off "
             "(invalidate on any mutation)", "auto")
declare_flag("drain/done-eps",
             "Relative completion threshold of the f32 drain executor "
             "(f64 drains use the absolute maxmin*surf precision)", 1e-4)


def lmm_flags():
    """The solver flags of the configuration as the
    :class:`~simgrid_tpu_torch.ops.lmm_host.LmmFlags` a System holds."""
    from ..ops.lmm_host import LmmFlags
    return LmmFlags(
        precision=config["maxmin/precision"],
        concurrency_limit=config["maxmin/concurrency-limit"],
        backend=config["lmm/backend"],
        threshold=config["lmm/jax-threshold"],
        dtype=config["lmm/dtype"],
        rounds=config["lmm/rounds"],
        warm_start=config["lmm/warm-start"],
        delta_upload=config["lmm/delta-upload"],
        strict=config["lmm/strict"],
        layout=config["lmm/layout"],
        chain=config["lmm/chain"])
