"""Model registry: named model tables + --cfg selection.

The port's copy of ``simgrid_tpu/models/registry.py`` (the reference's
model description tables, src/surf/surf_interface.cpp:56-116, and its
surf_*_model_init_* functions): models are picked by the host/model,
cpu/model, network/model and storage/model flags.  The port has the
host model CLM03, the CPU model Cas01 (Full and Lazy) and the network
models LV08, CM02 and Constant; any other name raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..kernel.resource import UpdateAlgo
from ..utils.config import config
from .cpu import CpuCas01Model
from .host import HostCLM03Model
from .network import NetworkCm02Model, NetworkConstantModel

network_models: Dict[str, Callable] = {}
cpu_models: Dict[str, Callable] = {}
host_models: Dict[str, Callable] = {}

#: models of the JAX package the port does not have yet, and the item of
#: ROADMAP queue A that ports each
_NOT_PORTED = {
    ("network/model", "SMPI"): "A21 (the remaining models)",
    ("network/model", "IB"): "A21 (the remaining models)",
    ("network/model", "Packet"): "A21 (the remaining models)",
    ("cpu/optim", "TI"): "A21 (the remaining models)",
    ("host/model", "ptask_L07"): "A21 (the remaining models)",
}


def _not_ported(flag: str, name: str) -> NotImplementedError:
    item = _NOT_PORTED.get((flag, name))
    where = (f"ROADMAP queue A, item {item}" if item
             else "no model of that name in the JAX package either")
    return NotImplementedError(
        f"{flag}:{name} is not ported to simgrid_tpu_torch ({where})")


def _register_defaults() -> None:
    def init_lv08(engine):
        config.set_default("network/latency-factor", 13.01)
        config.set_default("network/bandwidth-factor", 0.97)
        config.set_default("network/weight-S", 20537.0)
        return NetworkCm02Model(engine)

    def init_cm02(engine):
        config.set_default("network/latency-factor", 1.0)
        config.set_default("network/bandwidth-factor", 1.0)
        config.set_default("network/weight-S", 0.0)
        return NetworkCm02Model(engine)

    network_models.update({
        "LV08": init_lv08,
        "CM02": init_cm02,
        "Constant": NetworkConstantModel,
    })

    def init_cas01(engine):
        if config["cpu/optim"] == "TI":
            raise _not_ported("cpu/optim", "TI")
        algo = (UpdateAlgo.LAZY if config["cpu/optim"] == "Lazy"
                else UpdateAlgo.FULL)
        return CpuCas01Model(engine, algo)

    cpu_models["Cas01"] = init_cas01
    host_models["default"] = HostCLM03Model
    # 'compound' = separate cpu+network models composed by the host
    # model — exactly what HostCLM03Model does
    host_models["compound"] = HostCLM03Model


_register_defaults()


def _pick(table: Dict[str, Callable], flag: str) -> Callable:
    name = config[flag]
    factory = table.get(name)
    if factory is None:
        raise _not_ported(flag, name)
    return factory


def setup_models(engine) -> None:
    """Instantiate the configured models in the reference's creation order
    (host first so its wake-up sweep runs first, then cpu, then network).
    The storage model is not ported: ``engine.storage_model`` stays None,
    which the host model and ``surf_solve`` read as "no storage"; a
    platform that declares storage raises when it is loaded."""
    _pick(host_models, "host/model")(engine)
    engine.cpu_model = _pick(cpu_models, "cpu/model")(engine)
    _pick(network_models, "network/model")(engine)  # sets network_model
    engine.storage_model = None
