"""Consumer-group coordinator: partitions → worker shards.

Assignment is by *consistent hashing* (a ring of virtual nodes per member):
on join/leave/crash only the partitions owned by the affected member move,
so a rebalance does not reshuffle the whole group the way naive modulo
assignment would.  Every membership change bumps ``generation`` — the bus
pool uses that to know when shard assignments must be refreshed and
consumer-side state reset to the last checkpoint (Kafka's rebalance
semantics: a partition always restarts from its committed offset).
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Tuple


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class ConsumerGroup:
    def __init__(self, num_partitions: int, virtual_nodes: int = 64) -> None:
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.num_partitions = num_partitions
        self.virtual_nodes = virtual_nodes
        self.generation = 0
        self._members: List[str] = []
        self._ring: List[Tuple[int, str]] = []
        self._ring_keys: List[int] = []
        self._part_hash = [_hash(f"partition:{p}") for p in range(num_partitions)]
        self._lock = threading.RLock()

    # -- membership ------------------------------------------------------------
    def join(self, member: str) -> List[int]:
        """Add a member; returns its partition assignment."""
        with self._lock:
            if member not in self._members:
                self._members.append(member)
                self._rebuild()
                self.generation += 1
            return self.partitions_of(member)

    def leave(self, member: str) -> None:
        """Remove a member (graceful leave or observed crash)."""
        with self._lock:
            if member in self._members:
                self._members.remove(member)
                self._rebuild()
                self.generation += 1

    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def _rebuild(self) -> None:
        ring = [
            (_hash(f"{m}#vn{i}"), m)
            for m in self._members
            for i in range(self.virtual_nodes)
        ]
        ring.sort()
        self._ring = ring
        self._ring_keys = [h for h, _ in ring]

    # -- assignment ------------------------------------------------------------
    def assignment(self) -> Dict[str, List[int]]:
        """member -> sorted partition list; covers every partition exactly once.

        Consistent hashing *with bounded loads*: each partition goes to the
        first ring member clockwise from its hash point whose load is under
        ``ceil(P / N)``.  The cap keeps shards balanced (a plain ring is very
        lopsided for small member counts) while membership changes still move
        only a bounded set of partitions.
        """
        with self._lock:
            out: Dict[str, List[int]] = {m: [] for m in self._members}
            ring = self._ring
            if not ring:
                return out
            cap = -(-self.num_partitions // len(self._members))  # ceil
            n_ring = len(ring)
            for p in range(self.num_partitions):
                i = bisect.bisect_right(self._ring_keys, self._part_hash[p])
                for k in range(n_ring):
                    m = ring[(i + k) % n_ring][1]
                    if len(out[m]) < cap:
                        out[m].append(p)
                        break
            return out

    def owner(self, partition: int) -> Optional[str]:
        for m, parts in self.assignment().items():
            if partition in parts:
                return m
        return None

    def partitions_of(self, member: str) -> List[int]:
        return self.assignment().get(member, [])
