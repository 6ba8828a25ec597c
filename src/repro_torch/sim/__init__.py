from .simulator import ClusterSimulator, SimConfig, SimResult
from .trace import TraceJob, philly_like_trace

__all__ = ["ClusterSimulator", "SimConfig", "SimResult", "TraceJob",
           "philly_like_trace"]
