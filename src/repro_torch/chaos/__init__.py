# Deterministic fault injection for the failure-policy plane: seeded,
# replayable fault schedules over the runtime's real seams (publish, commit,
# consume, checkpoint, torn segment tails, SIGKILL points, dropped
# replication frames/acks, lease-expiry skew, host loss) plus the soaks that
# drive a fan-out workflow through them on both shard runtimes.
from .faults import (ChaosEventStore, ChaosStateStore, FaultPlan,
                     InjectedFault, tear_segment_tail)
from .soak import (assert_invariants, expected_results, fail_budget,
                   run_soak, run_soak_host_loss, run_soak_proc,
                   run_soak_replicated, soak_child_init)

__all__ = [
    "ChaosEventStore",
    "ChaosStateStore",
    "FaultPlan",
    "InjectedFault",
    "assert_invariants",
    "expected_results",
    "fail_budget",
    "run_soak",
    "run_soak_host_loss",
    "run_soak_proc",
    "run_soak_replicated",
    "soak_child_init",
    "tear_segment_tail",
]
