"""Port of ``repro.core``: the ABM engine in PyTorch.

Public API of this slice:
  Simulation               - facade: owns engine, state, scheduled ops
  Rebalance / Checkpoint   - the facade's load-balancing and checkpoint
                             policies; Rebalancer - the re-shard runtime
  AgentSchema / AgentSoA   - SoA agent container
  Domain / Partition       - N-D spatial spec
  Behavior / compose       - model definition (pair kernel + update) and
                             the composition of several
  Engine / SimState        - simulation engine on a virtual device mesh
  DeltaConfig              - aura-exchange delta / migration codec config
  GuardConfig / HealthError / health_counts
                           - runtime health guards (core.guards)
"""

from repro_torch.core.agent_soa import (
    AgentSchema, AgentSoA, GID_COUNT, GID_RANK, POS,
)
from repro_torch.core.behaviors import Behavior, compose
from repro_torch.core.delta import DeltaConfig
from repro_torch.core.domain import Domain, Partition
from repro_torch.core.engine import Engine, SimState, total_agents
from repro_torch.core.guards import GuardConfig, HealthError, health_counts
from repro_torch.core.reshard import Rebalancer
from repro_torch.core.simulation import Checkpoint, Rebalance, Simulation

__all__ = [
    "AgentSchema", "AgentSoA", "GID_COUNT", "GID_RANK", "POS", "Behavior",
    "Checkpoint", "compose",
    "DeltaConfig", "Domain", "Engine", "GuardConfig", "HealthError",
    "Partition", "Rebalance", "Rebalancer", "SimState", "Simulation",
    "health_counts", "total_agents",
]
