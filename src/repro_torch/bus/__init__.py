# Partitioned event bus + sharded worker-pool runtimes (paper §4 dataplane:
# Kafka partitions / Redis Streams consumer groups, scaled TF-Workers —
# threaded over the in-memory bus, or one OS process per shard over the
# durable file-backed bus), plus the host-loss fault domain (replicated
# segment transport + lease-fenced ownership).
from .group import ConsumerGroup
from .partitioned import (FencedWrite, FilePartitionedEventStore,
                          PartitionedEventStore, PartitionedStoreBase,
                          subject_partitioner)
from .pool import ShardedWorkerPool, ShardWorker
from .proc import ProcessShardPool
from .replicate import ReplicaServer, ReplicationClient

__all__ = [
    "ConsumerGroup",
    "FencedWrite",
    "FilePartitionedEventStore",
    "PartitionedEventStore",
    "PartitionedStoreBase",
    "ProcessShardPool",
    "ReplicaServer",
    "ReplicationClient",
    "ShardWorker",
    "ShardedWorkerPool",
    "subject_partitioner",
]
