"""Route tables of the transfer interpreters (counterpart of
``swiftmpi_tpu/transfer/plan.py``).

Only the pull family's route table is ported: the facts the pull
interpreter (``Transfer.pull``, ``transfer/api.py``) reads per backend.
The window routes, ``TrafficPlan``/``PullPlan`` and their pricers are
ROADMAP A12c/d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PullRoute:
    """``eager``: the pull primitive is the host oracle's (numpy), so the
    interpreter counts rows on the host.  ``placement``: ``flat`` (one
    gather over the whole slot space) or ``hot_split`` (hybrid: hot hits
    read from the local hot plane at 0 wire bytes, tail rows re-based by
    ``-n_hot`` and pulled through the tail backend)."""

    eager: bool = False
    placement: str = "flat"


#: backend name -> pull route
PULL_ROUTES: Dict[str, PullRoute] = {
    "local": PullRoute(eager=True),
    "xla": PullRoute(),
    "tpu": PullRoute(),
    "hybrid": PullRoute(placement="hot_split"),
}


def pull_route(backend: str) -> PullRoute:
    try:
        return PULL_ROUTES[backend]
    except KeyError:
        raise KeyError(f"transfer.plan: backend {backend!r} has no pull "
                       "route (add it to PULL_ROUTES)") from None
