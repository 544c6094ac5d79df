"""The SLA planner (copy of ``dynamo_tpu.planner``): load prediction to
replica decisions, live role flips and standby autoscaling.

``python -m dynamo_tpu_torch.planner`` runs it as a process. It reads
the workers' ForwardPassMetrics stream, the SLO plane's pressure and the
prefill queue's depth, and decides: replica counts per pool through a
connector (``planner/connector.py``, ``planner/kube.py``), role flips
(``planner/reconfig.py``) and standby promotions and retirements
(``planner/capacity.py``); ``planner/profiler.py`` measures the capacity
table it consumes.
"""

from dynamo_tpu_torch.planner.capacity import (
    CapacityConfig,
    CapacityModel,
    FleetScaler,
    apply_capacity_env,
)
from dynamo_tpu_torch.planner.connector import Connector, FakeConnector
from dynamo_tpu_torch.planner.core import Planner, PlannerConfig, PoolState
from dynamo_tpu_torch.planner.predictors import (
    ConstantPredictor,
    LinearTrendPredictor,
    MovingAveragePredictor,
    make_predictor,
)
from dynamo_tpu_torch.planner.profiler import (
    choose_capacity,
    profile_sweep,
)
from dynamo_tpu_torch.planner.reconfig import (
    ReconfigConfig,
    RoleReconfigurator,
    apply_reconfig_env,
)

__all__ = [
    "Connector", "FakeConnector", "Planner", "PlannerConfig", "PoolState",
    "ConstantPredictor", "LinearTrendPredictor", "MovingAveragePredictor",
    "make_predictor", "choose_capacity", "profile_sweep",
    "ReconfigConfig", "RoleReconfigurator", "apply_reconfig_env",
    "CapacityConfig", "CapacityModel", "FleetScaler", "apply_capacity_env",
]
