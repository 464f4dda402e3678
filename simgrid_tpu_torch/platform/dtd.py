"""Structural validation of platform XML against the simgrid.dtd
content model (src/surf/xml/simgrid.dtd).

The port's copy of ``simgrid_tpu/platform/dtd.py``.

The reference's FleXML-generated parser hard-errors on unknown tags,
unknown attributes, missing required attributes and out-of-enum values;
silently accepting them (as a naive ElementTree walk would) lets typos
produce a silently-wrong platform.  This is the same contract as a
validating DTD parse, expressed as a data-driven walk."""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

from ..exceptions import ParseError


def _s(*names) -> FrozenSet[str]:
    return frozenset(names)


#: tag -> (required attributes, optional attributes, allowed children)
SCHEMA: Dict[str, Tuple[FrozenSet[str], FrozenSet[str], FrozenSet[str]]] = {
    "platform": (_s(), _s("version"),
                 _s("config", "random", "include", "cluster", "cabinet",
                    "peer", "AS", "zone", "trace", "trace_connect",
                    "process", "actor")),
    "include": (_s("file"), _s(),
                _s("include", "cluster", "cabinet", "peer", "AS", "zone",
                   "trace", "trace_connect")),
    "trace": (_s("id", "periodicity"), _s("file"), _s()),
    "random": (_s("id", "min", "max", "mean", "std_deviation"),
               _s("seed", "radical", "generator"), _s()),
    "trace_connect": (_s("trace", "element"), _s("kind"), _s()),
    "AS": None,       # alias of zone, filled below
    "zone": (_s("id", "routing"),
             _s(),
             _s("prop", "AS", "zone", "host", "router", "link", "backbone",
                "route", "ASroute", "zoneRoute", "bypassRoute",
                "bypassASroute", "bypassZoneRoute", "cluster", "cabinet",
                "peer", "trace", "trace_connect", "storage",
                "storage_type", "host_link", "include")),
    "storage_type": (_s("id", "size"), _s("model", "content"),
                     _s("model_prop", "prop")),
    "storage": (_s("id", "typeId", "attach"), _s("content"), _s("prop")),
    "mount": (_s("storageId", "name"), _s(), _s()),
    "host": (_s("id", "speed"),
             _s("core", "speed_file", "availability_file", "state_file",
                "coordinates", "pstate"),
             _s("disk", "prop", "mount")),
    "disk": (_s("read_bw", "write_bw"), _s("id"), _s("prop")),
    "host_link": (_s("id", "up", "down"), _s(), _s()),
    "cluster": (_s("id", "prefix", "suffix", "radical", "speed", "bw",
                   "lat"),
                _s("core", "sharing_policy", "topology",
                   "topo_parameters", "bb_bw", "bb_lat",
                   "bb_sharing_policy", "router_id", "limiter_link",
                   "loopback_bw", "loopback_lat"),
                _s("prop")),
    "cabinet": (_s("id", "prefix", "suffix", "radical", "speed", "bw",
                   "lat"), _s(), _s()),
    "peer": (_s("id", "speed", "bw_in", "bw_out"),
             _s("lat", "coordinates", "speed_file", "availability_file",
                "state_file"), _s()),
    "router": (_s("id"), _s("coordinates"), _s()),
    "backbone": (_s("id", "bandwidth", "latency"), _s(), _s()),
    "link": (_s("id", "bandwidth"),
             _s("bandwidth_file", "latency", "latency_file", "state_file",
                "sharing_policy"), _s("prop")),
    "route": (_s("src", "dst"), _s("symmetrical"), _s("link_ctn")),
    "ASroute": (_s("src", "dst", "gw_src", "gw_dst"), _s("symmetrical"),
                _s("link_ctn")),
    "zoneRoute": (_s("src", "dst", "gw_src", "gw_dst"),
                  _s("symmetrical"), _s("link_ctn")),
    "link_ctn": (_s("id"), _s("direction"), _s()),
    "bypassRoute": (_s("src", "dst"), _s(), _s("link_ctn")),
    "bypassASroute": (_s("src", "dst", "gw_src", "gw_dst"), _s(),
                      _s("link_ctn")),
    "bypassZoneRoute": (_s("src", "dst", "gw_src", "gw_dst"), _s(),
                        _s("link_ctn")),
    "process": (_s("host", "function"),
                _s("start_time", "kill_time", "on_failure"),
                _s("argument", "prop")),
    "actor": (_s("host", "function"),
              _s("start_time", "kill_time", "on_failure"),
              _s("argument", "prop")),
    "argument": (_s("value"), _s(), _s()),
    "config": (_s(), _s("id"), _s("prop")),
    "prop": (_s("id", "value"), _s(), _s()),
    "model_prop": (_s("id", "value"), _s(), _s()),
}
SCHEMA["AS"] = SCHEMA["zone"]

#: attribute -> allowed values, where the DTD enumerates
ENUMS: Dict[Tuple[str, str], FrozenSet[str]] = {
    ("zone", "routing"): _s("Full", "Floyd", "Dijkstra", "DijkstraCache",
                            "None", "Vivaldi", "Cluster", "ClusterTorus",
                            "ClusterFatTree", "ClusterDragonfly"),
    ("cluster", "sharing_policy"): _s("SHARED", "SPLITDUPLEX",
                                      "FULLDUPLEX", "FATPIPE"),
    ("cluster", "topology"): _s("FLAT", "TORUS", "FAT_TREE", "DRAGONFLY"),
    ("cluster", "bb_sharing_policy"): _s("SHARED", "FATPIPE"),
    ("link", "sharing_policy"): _s("SHARED", "SPLITDUPLEX", "FULLDUPLEX",
                                   "FATPIPE", "WIFI"),
    ("route", "symmetrical"): _s("YES", "NO", "yes", "no"),
    ("link_ctn", "direction"): _s("UP", "DOWN", "NONE"),
    ("trace_connect", "kind"): _s("HOST_AVAIL", "SPEED", "LINK_AVAIL",
                                  "BANDWIDTH", "LATENCY"),
    ("process", "on_failure"): _s("DIE", "RESTART"),
}
ENUMS[("AS", "routing")] = ENUMS[("zone", "routing")]
for _t in ("ASroute", "zoneRoute"):
    ENUMS[(_t, "symmetrical")] = ENUMS[("route", "symmetrical")]
ENUMS[("actor", "on_failure")] = ENUMS[("process", "on_failure")]


def validate(root, path: str = "<platform>") -> None:
    """Walk the tree; raise ParseError on the first DTD violation."""
    if root.tag != "platform":
        raise ParseError(
            f"{path}: root element must be <platform>, got <{root.tag}>")
    _validate_elem(root, path, "platform")


def _validate_elem(elem, path: str, context: str) -> None:
    spec = SCHEMA.get(elem.tag)
    if spec is None:
        raise ParseError(f"{path}: unknown tag <{elem.tag}> in "
                         f"<{context}>")
    required, optional, children = spec
    attrs = set(elem.attrib)
    missing = required - attrs
    if missing:
        raise ParseError(
            f"{path}: <{elem.tag}> misses required attribute(s) "
            f"{sorted(missing)}")
    unknown = attrs - required - optional
    if unknown:
        raise ParseError(
            f"{path}: <{elem.tag}> has unknown attribute(s) "
            f"{sorted(unknown)} (allowed: "
            f"{sorted(required | optional)})")
    for (attr, allowed) in ((a, ENUMS.get((elem.tag, a)))
                            for a in attrs):
        if allowed is not None and elem.get(attr) not in allowed:
            raise ParseError(
                f"{path}: <{elem.tag} {attr}=\"{elem.get(attr)}\"> is "
                f"not one of {sorted(allowed)}")
    for child in elem:
        if child.tag not in children:
            raise ParseError(
                f"{path}: <{child.tag}> is not allowed inside "
                f"<{elem.tag}>")
        _validate_elem(child, path, elem.tag)
