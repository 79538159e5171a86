"""The autoscaler's import surface.

Port of `ray_tpu/core/autoscaler.py`: the policy lives in
:mod:`ray_tpu_torch.core.capacity` (demand ledger, spot-aware
provisioning, drain-path lifecycle); ``Autoscaler`` is its
:class:`~ray_tpu_torch.core.capacity.CapacityAutoscaler`, and the
providers and ``NodeType`` are re-exported unchanged.
"""

from __future__ import annotations

from .capacity import (  # noqa: F401
    CapacityAutoscaler,
    Demand,
    DemandLedger,
    FakeNodeProvider,
    LocalProcessNodeProvider,
    NodeProvider,
    NodeType,
    SpotNodeProvider,
    active_autoscaler,
    register_demand_source,
    unregister_demand_source,
)

Autoscaler = CapacityAutoscaler

__all__ = [
    "Autoscaler",
    "CapacityAutoscaler",
    "Demand",
    "DemandLedger",
    "FakeNodeProvider",
    "LocalProcessNodeProvider",
    "NodeProvider",
    "NodeType",
    "SpotNodeProvider",
    "active_autoscaler",
    "register_demand_source",
    "unregister_demand_source",
]
