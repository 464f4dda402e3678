"""s4u::Engine equivalent: simulation setup.

The port's copy of ``simgrid_tpu/s4u/engine.py`` (reference
src/s4u/s4u_Engine.cpp: load_platform, the registries, clock; plus
``--cfg`` command-line handling, sg_config.cpp).  It starts as the JAX
one does, ``Engine(argv)`` then ``load_platform(path)``, with one
addition: ``device=`` (``resolve_device``: the card unless ``"cpu"`` is
asked for, and an error where there is no card) is where every model's
System solves.  Deployments and ``run`` need actors, which are not
ported yet (ROADMAP queue A, item A3b): they raise.
"""

from __future__ import annotations

from typing import List, Optional

from ..device import DeviceLike
from ..kernel.engine import EngineImpl
from ..models.registry import setup_models
from ..platform.xml import PlatformLoader
from ..utils.config import config

_A3B = "ROADMAP queue A, item A3b (actors, EngineImpl.run)"


class Engine:
    on_platform_created = EngineImpl.on_platform_created
    on_time_advance = EngineImpl.on_time_advance

    def __init__(self, argv: Optional[List[str]] = None,
                 device: DeviceLike = None):
        # --cfg lands before the kernel comes up (reference order too:
        # sg_config runs first, sg_config.cpp)
        if argv:
            rest = config.parse_argv(argv[1:])
            argv[1:] = rest
        self.pimpl = EngineImpl(device)
        self._models_ready = False

    @classmethod
    def _reset(cls) -> None:
        """Tear down the process-wide simulation state (the registry of
        named profiles) so a fresh Engine can load a platform that
        declares the same traces (mainly for test harnesses)."""
        from ..kernel import profile as profile_mod
        profile_mod.clear_trace_registry()

    @property
    def device(self):
        return self.pimpl.device

    @property
    def clock(self) -> float:
        return self.pimpl.now

    # -- platform ----------------------------------------------------------
    def load_platform(self, path: str) -> None:
        if not self._models_ready:
            setup_models(self.pimpl)
            self._models_ready = True
        PlatformLoader(self.pimpl).load(path)

    # -- actors (not ported) -----------------------------------------------
    def load_deployment(self, path: str) -> None:
        raise NotImplementedError(
            f"deployments start actors, which are not ported yet ({_A3B})")

    def run(self) -> None:
        raise NotImplementedError(
            f"Engine.run schedules actors, which are not ported yet "
            f"({_A3B}); step the engine with engine.pimpl.surf_solve")

    # -- entity lookup -----------------------------------------------------
    def host_by_name(self, name: str):
        host = self.pimpl.hosts.get(name)
        assert host is not None, f"Host '{name}' not found"
        return host

    def get_all_hosts(self) -> List:
        # name-sorted like the reference (its host registry is a
        # std::map, Engine::get_all_hosts iterates in name order)
        return [h for _, h in sorted(self.pimpl.hosts.items())]

    def get_host_count(self) -> int:
        return len(self.pimpl.hosts)

    def link_by_name(self, name: str):
        link = self.pimpl.links.get(name)
        assert link is not None, f"Link '{name}' not found"
        return link

    def get_all_links(self) -> List:
        return list(self.pimpl.links.values())

    def get_netzone_root(self):
        return self.pimpl.netzone_root
