"""Trigger = (Event, Context, Condition, Action) 4-tuple (paper Def. 2).

Triggers are *serializable*: conditions and actions are referenced by
registry name + JSON params, so a trigger survives a worker restart and can be
shipped to the state store — exactly what the paper needs for fault tolerance
and for dynamic trigger creation from inside actions (§5.3).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_tid = itertools.count()


def new_trigger_id(prefix: str = "tg") -> str:
    return f"{prefix}-{next(_tid):x}"


@dataclass
class Trigger:
    # Subjects of CloudEvents that activate this trigger.
    activation_events: List[str]
    condition: Dict[str, Any]  # {"name": <registry name>, ...params}
    action: Dict[str, Any]     # {"name": <registry name>, ...params}
    context: Dict[str, Any] = field(default_factory=dict)
    trigger_id: str = field(default_factory=new_trigger_id)
    transient: bool = True      # transient triggers deactivate after firing (Def. 2)
    enabled: bool = True
    # Optional filter on CloudEvent.type ("" = any).
    event_type: str = ""
    # Optional RetryPolicy spec (dict form — see core.policy).  None keeps the
    # pre-policy semantics: failures print and the event commits as consumed.
    retry_policy: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "trigger_id": self.trigger_id,
            "activation_events": list(self.activation_events),
            "condition": self.condition,
            "action": self.action,
            "context": self.context,
            "transient": self.transient,
            "enabled": self.enabled,
            "event_type": self.event_type,
        }
        if self.retry_policy is not None:
            d["retry_policy"] = self.retry_policy
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Trigger":
        return Trigger(
            activation_events=list(d["activation_events"]),
            condition=dict(d["condition"]),
            action=dict(d["action"]),
            context=dict(d.get("context", {})),
            trigger_id=d["trigger_id"],
            transient=d.get("transient", True),
            enabled=d.get("enabled", True),
            event_type=d.get("event_type", ""),
            retry_policy=d.get("retry_policy"),
        )


def make_trigger(
    subjects,
    condition: Optional[Dict[str, Any]] = None,
    action: Optional[Dict[str, Any]] = None,
    context: Optional[Dict[str, Any]] = None,
    trigger_id: Optional[str] = None,
    transient: bool = True,
    event_type: str = "",
    retry=None,
) -> Trigger:
    from .policy import coerce_retry_policy

    if isinstance(subjects, str):
        subjects = [subjects]
    return Trigger(
        activation_events=list(subjects),
        condition=condition or {"name": "true"},
        action=action or {"name": "noop"},
        context=context or {},
        trigger_id=trigger_id or new_trigger_id(),
        transient=transient,
        event_type=event_type,
        retry_policy=coerce_retry_policy(retry),
    )
