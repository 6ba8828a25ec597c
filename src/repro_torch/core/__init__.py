"""Parameter Service control plane (the paper's primary contribution).

Public surface:
  ParameterService      cluster-wide shared aggregation service facade
  JobProfile / AggTask  profiled job description
  assignment            Pseudocode-1 heuristic + ps-lite/AutoPS placements
  cyclic                cyclic execution schedules + straggler outliers
  migration             tensor-migration protocol + overlap cost model
  ip_model              Appendix-C IP evaluator + exact tiny-instance solver
"""

from .types import (
    AggTask,
    Aggregator,
    AssignmentDecision,
    JobProfile,
    cpu_reduction_ratio,
    cyclic_loss,
    effective_iteration,
    iterations_per_cycle,
)
from .assignment import (
    AssignmentConfig,
    DEFAULT_LOSS_LIMIT,
    assign_job,
    assign_task,
    balanced_shard_assignment,
    round_robin_shard_assignment,
    shard_imbalance,
)
from .service import ParameterService
from .perf_model import predict_iteration, predict_loss, predict_all_losses

__all__ = [
    "AggTask",
    "Aggregator",
    "AssignmentDecision",
    "AssignmentConfig",
    "DEFAULT_LOSS_LIMIT",
    "JobProfile",
    "ParameterService",
    "assign_job",
    "assign_task",
    "balanced_shard_assignment",
    "round_robin_shard_assignment",
    "shard_imbalance",
    "cpu_reduction_ratio",
    "cyclic_loss",
    "effective_iteration",
    "iterations_per_cycle",
    "predict_iteration",
    "predict_loss",
    "predict_all_losses",
]
