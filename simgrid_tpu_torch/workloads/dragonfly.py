"""The BASELINE config-#4 systems on a 65,536-host dragonfly.

A vectorised numpy generator of the LMM systems the JAX engine builds in
``tools/e2e_drain.py:50-106`` (``--workload random`` and ``alltoall``)
and ``tools/e2e_probe.py:53-104`` (the 320-rank alltoall), without the
engine:

* the platform of ``tools/scale_proof.py:24-40``: one cluster ``dfly``
  of 65,536 hosts, ``topology="DRAGONFLY"``,
  ``topo_parameters="16,3;4,2;16,2;64"`` (16 groups with 3 blue links,
  4 chassis with 2 black links, 16 blades with 2 green links, 64 nodes
  per blade), 125 MBps links, SPLITDUPLEX (an ``_UP`` and a ``_DOWN``
  constraint per link), and a multi-link class scaling its bandwidth by
  its link count;
* the links and their names as ``simgrid_tpu/routing/topo.py:434-498``
  creates them, and its minimal routing (``:500-559``) with the
  reference's flat router offsets (after a gateway or in-group green hop
  the walk continues from chassis 0);
* the CM02 expansion of ``simgrid_tpu/models/network.py:346-452``:
  weight 1.0 on every link of the forward route and the cross-traffic
  weight 0.05 on every link of the reverse route, each link constraint
  bounded by ``bw_factor * bandwidth`` (LV08's 0.97, ``network.py:509``);
* the flow pairs of ``tools/e2e_drain.py:80-87``: ``default_rng(42)``
  draws ``(flows, 2)`` host indices into the NAME-SORTED host list, and
  ``src == dst`` moves ``dst`` to the next host; or the alltoall of
  ``:71-78``: rank i on host ``i * (n_hosts // ranks)`` of that list,
  every ordered pair i != j, i outer and j inner;
* with ``lv08=True``, the penalty and rate bound the LV08 engine gives
  each flow (``network.py:346-421``): the route latency summed link by
  link in route order from 0.0 (``routing/zone.py:125-128``), then
  ``+= weight_S / bandwidth`` link by link along the forward route, and
  the bound ``TCP_gamma / (2 * latency)``.  The engine installs the
  penalty when the latency phase ends (``network.py:307-309``); the
  float operations are the engine's, in its order, so the values are
  equal, not close.  The constants are this module's own copy of the
  LV08 defaults.

Elements are ordered flow by flow (forward route, then reverse route)
and constraints by first use, so flow k is variable k.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

#: groups,blue links ; chassis,black links ; blades,green links ; nodes
TOPOLOGY = "16,3;4,2;16,2;64"
BANDWIDTH = 125.0 * 1e6       # "125MBps", as the platform parser reads it
LATENCY = 50.0 * 1e-6         # "50us"
BW_FACTOR = 0.97
CROSSTRAFFIC = 0.05
ZONE = "dfly"
#: LV08 defaults: network/weight-S and network/TCP-gamma
WEIGHT_S = 20537.0
TCP_GAMMA = 4194304.0


class DrainSystem(NamedTuple):
    e_var: np.ndarray     # [E] int32 — flow per element
    e_cnst: np.ndarray    # [E] int32 — link constraint per element
    e_w: np.ndarray       # [E] float64
    c_bound: np.ndarray   # [C] float64
    sizes: np.ndarray     # [V] float64
    link_ids: np.ndarray  # [C] int64 — directed link id per constraint
    n_hosts: int
    v_penalty: Optional[np.ndarray] = None   # [V] float64 (lv08)
    v_bound: Optional[np.ndarray] = None     # [V] float64 (lv08)

    @property
    def n_cnst(self) -> int:
        return len(self.c_bound)

    @property
    def n_elem(self) -> int:
        return len(self.e_var)


class Dragonfly:
    """Link numbering, names and minimal routing of one dragonfly.

    A link of the zone has a creation number ``uid`` (the reference's
    counter), and each of its two directions a directed id
    ``2*uid`` (``_UP``) or ``2*uid + 1`` (``_DOWN``)."""

    def __init__(self, topology: str = TOPOLOGY, zone: str = ZONE):
        parts = [p.split(",") for p in topology.split(";")]
        self.G, self.n_blue = int(parts[0][0]), int(parts[0][1])
        self.C, self.n_black = int(parts[1][0]), int(parts[1][1])
        self.B, self.n_green = int(parts[2][0]), int(parts[2][1])
        self.N = int(parts[3][0])
        self.zone = zone
        self.R = self.G * self.C * self.B
        self.n_hosts = self.R * self.N
        self.pairs_b = self.B * (self.B - 1) // 2
        self.pairs_c = self.C * (self.C - 1) // 2
        self.base_green = self.R * self.N
        self.base_black = self.base_green + self.G * self.C * self.pairs_b
        self.base_blue = self.base_black + self.G * self.pairs_c * self.B
        self.n_uid = self.base_blue + self.G * (self.G - 1) // 2

    # -- numbering ---------------------------------------------------------

    @staticmethod
    def _pair(j, k, n):
        """Index of the unordered pair j < k among n items, in the
        reference's nested-loop creation order."""
        return j * n - j * (j + 1) // 2 + (k - j - 1)

    def router(self, g, c, b):
        return (g * self.C + c) * self.B + b

    def coords(self, rank):
        per_group = self.C * self.B * self.N
        g, r = np.divmod(rank, per_group)
        c, r = np.divmod(r, self.B * self.N)
        b, n = np.divmod(r, self.N)
        return g, c, b, n

    def local(self, g, c, b, n, down):
        return 2 * (self.router(g, c, b) * self.N + n) + down

    def green(self, g, c, b, k):
        """Router (g,c,b)'s green link to blade k of its chassis."""
        lo, hi = np.minimum(b, k), np.maximum(b, k)
        uid = (self.base_green + (g * self.C + c) * self.pairs_b
               + self._pair(lo, hi, self.B))
        return 2 * uid + (b > k)

    def black(self, g, c, b, k):
        """Router (g,c,b)'s black link to chassis k of its group."""
        lo, hi = np.minimum(c, k), np.maximum(c, k)
        uid = (self.base_black + g * self.pairs_c * self.B
               + self._pair(lo, hi, self.C) * self.B + b)
        return 2 * uid + (c > k)

    def blue(self, g, b):
        """The blue link of gateway router (g, 0, b), towards group b."""
        lo, hi = np.minimum(g, b), np.maximum(g, b)
        uid = self.base_blue + self._pair(lo, hi, self.G)
        return 2 * uid + (g > b)

    def link_count(self, lid):
        """Links in each directed link's class (bandwidth multiplier)."""
        uid = np.asarray(lid) // 2
        return np.where(uid >= self.base_blue, self.n_blue,
                        np.where(uid >= self.base_black, self.n_black,
                                 np.where(uid >= self.base_green,
                                          self.n_green, 1)))

    def name(self, lid: int) -> str:
        uid, down = divmod(int(lid), 2)
        z = self.zone
        if uid < self.base_green:
            r, j = divmod(uid, self.N)
            s = f"{z}_local_link_from_router_{r}_to_node_{j}_{uid}"
        elif uid < self.base_black:
            i, p = divmod(uid - self.base_green, self.pairs_b)
            j, k = self._unpair(p, self.B)
            s = (f"{z}_green_link_in_chassis_{i % self.C}_between_routers_"
                 f"{j}_and_{k}_{uid}")
        elif uid < self.base_blue:
            g, p = divmod(uid - self.base_black, self.pairs_c * self.B)
            pc, b = divmod(p, self.B)
            j, k = self._unpair(pc, self.C)
            s = (f"{z}_black_link_in_group_{g}_between_chassis_{j}_and_{k}"
                 f"_blade_{b}_{uid}")
        else:
            i, j = self._unpair(uid - self.base_blue, self.G)
            pg = self.C * self.B
            s = (f"{z}_blue_link_between_group_{i}_and_{j}_routers_"
                 f"{i * pg + j}_and_{j * pg + i}_{uid}")
        return s + ("_DOWN" if down else "_UP")

    def _unpair(self, p: int, n: int):
        for j in range(n):
            row = n - j - 1
            if p < row:
                return j, j + 1 + p
            p -= row
        raise ValueError("pair index out of range")

    # -- routing -----------------------------------------------------------

    def routes(self, src, dst) -> np.ndarray:
        """Directed link ids of the minimal route of each (src, dst) rank
        pair, as a [F, 7] array padded with -1."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        F = len(src)
        mg, mc, mb, mn = self.coords(src)
        tg, tc, tb, tn = self.coords(dst)
        out = np.full((F, 7), -1, np.int64)
        out[:, 0] = self.local(mg, mc, mb, mn, 0)
        other = ~((mg == tg) & (mc == tc) & (mb == tb))
        cg, cc, cb = mg.copy(), mc.copy(), mb.copy()
        inter = other & (tg != mg)
        # reach the group gateway (mg, 0, tg) ...
        h = inter & (cb != tg)
        out[h, 1] = self.green(cg, cc, cb, tg)[h]
        cb = np.where(h, tg, cb)
        h = inter & (cc != 0)
        out[h, 2] = self.black(cg, cc, cb, 0)[h]
        cc = np.where(h, 0, cc)
        # ... hop the blue link and land on the peer gateway (tg, 0, mg)
        out[inter, 3] = self.blue(cg, cb)[inter]
        cg = np.where(inter, tg, cg)
        cc = np.where(inter, 0, cc)
        cb = np.where(inter, mg, cb)
        # in the target group: green to blade tb (the walk continues from
        # chassis 0, as the reference's flat offset does), then black
        h = other & (tb != cb)
        out[h, 4] = self.green(cg, cc, cb, tb)[h]
        cc = np.where(h, 0, cc)
        cb = np.where(h, tb, cb)
        h = other & (tc != cc)
        out[h, 5] = self.black(cg, cc, cb, tc)[h]
        out[:, 6] = self.local(tg, tc, tb, tn, 1)
        return out


def host_ranks(n_hosts: int) -> np.ndarray:
    """Rank of each host in the engine's name-sorted host list
    (``node-0``, ``node-1``, ``node-10``, ...)."""
    names = sorted(f"node-{i}" for i in range(n_hosts))
    return np.array([int(s[5:]) for s in names], np.int64)


def flow_pairs(flows: int, n_hosts: int, seed: int = 42) -> np.ndarray:
    """(src, dst) host-list indices exactly as ``tools/e2e_drain.py``
    draws them."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n_hosts, size=(flows, 2))
    same = pairs[:, 0] == pairs[:, 1]
    pairs[same, 1] = (pairs[same, 1] + 1) % n_hosts
    return pairs


def alltoall_pairs(ranks: int, n_hosts: int) -> np.ndarray:
    """(src, dst) host-list indices of the alltoall of ``ranks`` ranks,
    rank i on host ``i * (n_hosts // ranks)``, in the loop order of
    ``tools/e2e_drain.py`` (i outer, j inner, i != j)."""
    host = np.arange(ranks, dtype=np.int64) * (n_hosts // ranks)
    i, j = np.meshgrid(np.arange(ranks), np.arange(ranks), indexing="ij")
    off = i != j
    return np.stack([host[i[off]], host[j[off]]], axis=1)


def lv08_values(df: Dragonfly, fwd: np.ndarray):
    """The LV08 penalty and rate bound of each flow from its forward
    route (``[F, 7]`` directed link ids, -1 padded, in route order)."""
    used = fwd >= 0
    lat = np.zeros(len(fwd))
    for k in range(fwd.shape[1]):
        lat = np.where(used[:, k], lat + LATENCY, lat)
    pen = lat.copy()
    bw = BANDWIDTH * df.link_count(np.where(used, fwd, 0)).astype(
        np.float64)
    for k in range(fwd.shape[1]):
        pen = np.where(used[:, k], pen + WEIGHT_S / bw[:, k], pen)
    return pen, TCP_GAMMA / (2.0 * lat)


def build_system(flows: int = 100_000, seed: int = 42, size: float = 1e6,
                 topology: str = TOPOLOGY, pairs: Optional[np.ndarray] = None,
                 lv08: bool = False) -> DrainSystem:
    """The config-#4 drain system: COO elements, link bounds, sizes;
    ``pairs`` (host-list indices) replaces the random draw, and
    ``lv08`` adds each flow's LV08 penalty and rate bound."""
    df = Dragonfly(topology)
    ranks = host_ranks(df.n_hosts)
    if pairs is None:
        pairs = flow_pairs(flows, df.n_hosts, seed)
    flows = len(pairs)
    src, dst = ranks[pairs[:, 0]], ranks[pairs[:, 1]]
    fwd = df.routes(src, dst)
    back = df.routes(dst, src)
    links = np.concatenate([fwd, back], axis=1)            # [F, 14]
    weights = np.concatenate([np.ones(fwd.shape), np.full(back.shape,
                                                         CROSSTRAFFIC)],
                             axis=1)
    used = links >= 0
    flow = np.broadcast_to(np.arange(flows)[:, None], links.shape)[used]
    lid = links[used]
    w = weights[used]
    uniq, first, inv = np.unique(lid, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")               # first-use order
    rank_of = np.empty(len(uniq), np.int64)
    rank_of[order] = np.arange(len(uniq))
    link_ids = uniq[order]
    c_bound = BW_FACTOR * (BANDWIDTH * df.link_count(link_ids)
                           .astype(np.float64))
    pen, vb = lv08_values(df, fwd) if lv08 else (None, None)
    return DrainSystem(e_var=flow.astype(np.int32),
                       e_cnst=rank_of[inv.reshape(-1)].astype(np.int32),
                       e_w=w.astype(np.float64), c_bound=c_bound,
                       sizes=np.full(flows, float(size)),
                       link_ids=link_ids, n_hosts=df.n_hosts,
                       v_penalty=pen, v_bound=vb)


def build_alltoall(ranks: int = 320, size: float = 1e6, lv08: bool = True,
                   topology: str = TOPOLOGY) -> DrainSystem:
    """BASELINE config #4 as named: the ``ranks``-rank alltoall (every
    ordered pair, ``size`` bytes each) on the dragonfly, by default with
    the LV08 penalties and bounds the engine gives its flows."""
    n_hosts = Dragonfly(topology).n_hosts
    return build_system(size=size, topology=topology, lv08=lv08,
                        pairs=alltoall_pairs(ranks, n_hosts))


def link_names(system: DrainSystem, topology: str = TOPOLOGY) -> List[str]:
    """Link name of each constraint (the engine's naming)."""
    df = Dragonfly(topology)
    return [df.name(lid) for lid in system.link_ids]
