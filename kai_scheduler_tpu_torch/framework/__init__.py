from .scheduler import (CycleResult, Scheduler, SchedulerConfig,
                        action_names, register_action)
from .session import Session, SessionConfig

__all__ = [
    "CycleResult", "Scheduler", "SchedulerConfig", "Session",
    "SessionConfig", "action_names", "register_action",
]
