"""Distributed runtime of the port: so far only the step watchdog
(``watchdog.py``) that the serving front door and the flight recorder
use."""

from .watchdog import CommTaskManager, get_comm_task_manager, watch

__all__ = ["CommTaskManager", "get_comm_task_manager", "watch"]
