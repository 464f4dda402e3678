"""The port's platform layer (``platform/``, ``routing/``, the models'
resources) against the JAX package's on the CPU: the same XML loads into
the same hosts and links by name, with equal speeds, bandwidths,
latencies and sharing policies, and a seeded sample of host pairs routes
over equal link names with equal summed latency.  Both engines stay
alive side by side (one JAX, one port), so each platform is parsed once
per package (module fixtures)."""

import numpy as np
import pytest

from simgrid_tpu import s4u as jax_s4u
from simgrid_tpu_torch import s4u
from simgrid_tpu_torch.utils.config import config as port_config
from simgrid_tpu_torch.workloads.engine_run import make_engine, write_platform

#: a small dragonfly with every link class (2 groups, 2 chassis, 3
#: blades, 4 nodes: 48 hosts)
SMALL_DRAGONFLY = "2,1;2,2;3,1;4"


@pytest.fixture(autouse=True)
def _fresh_port_config():
    """The port's flags restored after each test (conftest restores the
    JAX package's)."""
    with port_config.scoped():
        yield


def _load_both(path):
    jax_e, _ = make_engine(jax_s4u, ["network/optim:Full"], path)
    port_e, _ = make_engine(s4u, ["network/optim:Full"], path, device="cpu")
    return jax_e, port_e


@pytest.fixture(scope="module", params=["fat_tree", "dragonfly"])
def engines(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plat") / f"{request.param}.xml")
    write_platform(path, request.param, topology=SMALL_DRAGONFLY)
    with port_config.scoped():
        jax_e, port_e = _load_both(path)
    yield request.param, jax_e, port_e
    jax_s4u.Engine._reset()
    s4u.Engine._reset()


def test_hosts_equal(engines):
    _, je, pe = engines
    jh, ph = je.get_all_hosts(), pe.get_all_hosts()
    assert [h.name for h in jh] == [h.name for h in ph]
    assert len(ph) in (64, 48)
    for a, b in zip(jh, ph):
        assert a.cpu.speed_per_pstate == b.cpu.speed_per_pstate
        assert a.cpu.core_count == b.cpu.core_count
        assert a.netpoint.id == b.netpoint.id


def test_links_equal(engines):
    _, je, pe = engines
    jl = {link.name: link for link in je.get_all_links()}
    pl = {link.name: link for link in pe.get_all_links()}
    assert list(jl) == list(pl)
    for name, a in jl.items():
        b = pl[name]
        assert a.get_bandwidth() == b.get_bandwidth(), name
        assert a.get_latency() == b.get_latency(), name
        assert a.constraint.bound == b.constraint.bound, name
        assert a.get_sharing_policy().name == b.get_sharing_policy().name


def test_routes_equal(engines):
    """A seeded sample of host pairs (self pairs included) routes over
    the same links in the same order, with the same summed latency."""
    kind, je, pe = engines
    jh, ph = je.get_all_hosts(), pe.get_all_hosts()
    pairs = np.random.default_rng(3).integers(0, len(jh), size=(200, 2))
    hops = set()
    for s, d in pairs:
        if s == d:
            continue
        jr, pr = [], []
        jlat = jh[s].route_to(jh[d], jr)
        plat = ph[s].route_to(ph[d], pr)
        assert [x.name for x in jr] == [x.name for x in pr]
        assert jlat == plat
        hops.add(len(pr))
    # the sample crosses more than one level of the topology
    assert len(hops) >= 2, (kind, hops)


def test_netzones_equal(engines):
    _, je, pe = engines
    jz, pz = je.get_netzone_root(), pe.get_netzone_root()
    assert type(jz).__name__ == type(pz).__name__
    assert [type(c).__name__ for c in jz.children] == \
        [type(c).__name__ for c in pz.children]
    assert sorted(je.pimpl.netpoints) == sorted(pe.pimpl.netpoints)
