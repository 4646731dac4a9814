# The paper's primary contribution: the Rich Trigger (ECA) service.
from .actions import (
    ACTIONS,
    BATCHED_ACTIONS,
    PYFUNCS,
    action,
    batched_action,
    pyfunc,
    register_action,
    register_pyfunc,
    run_action_batch,
)
from .autoscaler import KedaAutoscaler
from .conditions import (
    BATCHED_CONDITIONS,
    CONDITIONS,
    FIRE_RUN_CONDITIONS,
    batched_condition,
    condition,
    fire_run_condition,
    register_condition,
    scalar_sweep,
)
from .context import TriggerContext
from .events import (
    TYPE_FAILURE,
    TYPE_INIT,
    TYPE_TERMINATION,
    TYPE_TIMEOUT,
    TYPE_WORKFLOW_END,
    CloudEvent,
    failure_event,
    termination_event,
)
from .eventstore import EventStore, FileEventStore, MemoryEventStore
from .functions import FunctionBackend, TimerSource
from .service import Triggerflow
from .statestore import FileStateStore, MemoryStateStore, StateStore
from .triggers import Trigger, make_trigger, new_trigger_id
from .worker import TFWorker

__all__ = [
    "ACTIONS", "BATCHED_ACTIONS", "BATCHED_CONDITIONS", "CONDITIONS",
    "FIRE_RUN_CONDITIONS", "PYFUNCS", "CloudEvent",
    "EventStore",
    "FileEventStore", "FileStateStore", "FunctionBackend", "KedaAutoscaler",
    "MemoryEventStore", "MemoryStateStore", "StateStore", "TFWorker",
    "TimerSource", "Trigger", "TriggerContext", "Triggerflow", "TYPE_FAILURE",
    "TYPE_INIT", "TYPE_TERMINATION", "TYPE_TIMEOUT", "TYPE_WORKFLOW_END",
    "action", "batched_action", "batched_condition", "condition",
    "failure_event", "fire_run_condition",
    "make_trigger", "new_trigger_id", "pyfunc", "register_action",
    "register_condition", "register_pyfunc", "run_action_batch",
    "scalar_sweep", "termination_event",
]
