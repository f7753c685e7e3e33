from .elastic import PodMonitor, RescalePlan
from .ft import HeartbeatMonitor, RecoveryEvent, Supervisor

__all__ = ["PodMonitor", "RescalePlan", "HeartbeatMonitor", "RecoveryEvent",
           "Supervisor"]
