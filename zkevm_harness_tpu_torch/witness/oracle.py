"""Witness oracle: tracer -> per-circuit artifacts (queues, dedups, instances).

Counterpart of the JAX package's `witness/oracle.py` (the round-1 slice of
the reference's `create_artifacts_from_tracer`, src/witness/oracle.rs:185),
ported in part: the log-queue demux into the query classes
(`demux_log_queue`, log_demux.rs:20), the events / L1-message dedup by
rollback cancellation (`dedup_events`, events_sort_dedup.rs), the instance
count at a capacity (`_instances_for`) and `PerCircuitArtifacts`.

Not ported yet: `create_artifacts_from_tracer` and `BlockArtifacts`. They
call every witness decomposer of the block (decommitter, precompiles,
linear hasher, storage application, callstack, recursion queues), and the
port has the MainVM, RAM-permutation, log-demux and sorter decomposers
only; the rest of the pipeline comes with them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..vm.environment import (AUX_BYTE_EVENT, AUX_BYTE_L1_MESSAGE,
                              AUX_BYTE_PRECOMPILE, AUX_BYTE_STORAGE,
                              DefaultPrecompilesProcessor, LogQuery)
from .queues import QueueSimulator

P = 0xFFFFFFFF_00000001


@dataclasses.dataclass
class PerCircuitArtifacts:
    queue: QueueSimulator
    num_instances: int
    capacity: int


def _instances_for(count: int, capacity: int) -> int:
    return max(1, -(-count // capacity))


def demux_log_queue(queue: List[Tuple[int, LogQuery]]
                    ) -> Dict[str, List[Tuple[int, LogQuery]]]:
    """Split by class (log_demux.rs): storage, events, L1 msgs, and the three
    precompile streams by address."""
    out: Dict[str, List[Tuple[int, LogQuery]]] = {
        "storage": [], "events": [], "l1": [],
        "keccak": [], "sha256": [], "ecrecover": [],
    }
    for cycle, q in queue:
        if q.aux_byte == AUX_BYTE_STORAGE:
            out["storage"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_EVENT:
            out["events"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_L1_MESSAGE:
            out["l1"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_PRECOMPILE:
            if q.address == DefaultPrecompilesProcessor.KECCAK_ADDRESS:
                out["keccak"].append((cycle, q))
            elif q.address == DefaultPrecompilesProcessor.SHA256_ADDRESS:
                out["sha256"].append((cycle, q))
            else:
                out["ecrecover"].append((cycle, q))
    return out


def dedup_events(events: List[LogQuery]) -> List[LogQuery]:
    """Cancel (forward, rollback) pairs by timestamp; keep net events in
    original order (events_sort_dedup.rs behavior)."""
    rolled_back = {q.timestamp for q in events if q.rollback}
    return [q for q in events
            if not q.rollback and q.timestamp not in rolled_back]
