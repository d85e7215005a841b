"""Cloud provider layer: dynamic node pools, pricing, spot preemption, a
CLUES-style node autoscaler, and demand-aware per-zone spot bidding — the
pay-as-you-go substrate the paper's elastic scheduler is judged against
(see README §Cloud subsystem, §Spot bidding).

Copy of ``repro.cloud`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.
"""
from repro_torch.cloud.bidding import (BidderConfig, DemandAwareBidder,
                                       SpotRiskLedger, ZoneRisk)
from repro_torch.cloud.cost import CostAccountant, CostReport
from repro_torch.cloud.node_autoscaler import (AutoscalerConfig, NodeAutoscaler,
                                               NodeAutoscalerConfig)
from repro_torch.cloud.provider import (ON_DEMAND, SPOT, CloudProvider, Node,
                                        NodePool, NodeState)
from repro_torch.cloud.sim import CloudSimulator, KillBlast

__all__ = [
    "BidderConfig", "DemandAwareBidder", "SpotRiskLedger", "ZoneRisk",
    "CostAccountant", "CostReport", "AutoscalerConfig", "NodeAutoscaler",
    "NodeAutoscalerConfig", "ON_DEMAND", "SPOT", "CloudProvider", "Node",
    "NodePool", "NodeState", "CloudSimulator", "KillBlast",
]
