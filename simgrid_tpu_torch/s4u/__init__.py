"""s4u — the user-facing simulation API of the port (reference
include/simgrid/s4u/), its engine half: actors, mailboxes and
activities are not ported yet (ROADMAP queue A, item A3b).

Usage::

    from simgrid_tpu_torch import s4u

    e = s4u.Engine(["sim", "--cfg=network/optim:Full"], device="cpu")
    e.load_platform("platform.xml")
    a, b = e.get_all_hosts()[:2]
    model = e.pimpl.network_model
    action = model.communicate(a, b, 1e6, -1.0)
    while e.pimpl.surf_solve(-1.0) >= 0:
        done = model.extract_done_action()
"""

from ..models.host import Host
from ..models.network import LinkImpl as Link
from .engine import Engine

__all__ = ["Engine", "Host", "Link"]
