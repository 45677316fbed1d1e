"""MainVM instance splitting: snapshot-to-snapshot witness chunks.

Counterpart of the JAX package's `witness/vm_instance.py`, as it is.
Parity with the per-instance MainVM flow of the oracle
(src/witness/oracle.rs:1164-1420 `VmInstanceWitness` over snapshot pairs,
SURVEY stack 3.3): the tracer snapshots the VM every
`cycles_per_vm_snapshot` cycles (tracer.rs:249-263); each adjacent snapshot
pair becomes one MainVM circuit instance whose hidden FSM state is the full
machine state at the boundary, with the instance's slice of the
memory/log/decommit queues attached.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .tracer import WitnessTracer


@dataclasses.dataclass
class QueueSlices:
    memory: Tuple[int, int]
    logs: Tuple[int, int]
    decommits: Tuple[int, int]


@dataclasses.dataclass
class VmInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    cycle_range: Tuple[int, int]
    initial_state: object  # snapshot repr at entry
    final_state: Optional[object]  # snapshot repr at exit (None = end of run)
    queue_slices: QueueSlices


def _range_for(entries: List[Tuple[int, object]], lo: int, hi: int
               ) -> Tuple[int, int]:
    start = next((i for i, (c, _) in enumerate(entries) if c >= lo),
                 len(entries))
    end = next((i for i, (c, _) in enumerate(entries) if c >= hi),
               len(entries))
    return (start, end)


def split_into_vm_instances(tracer: WitnessTracer) -> List[VmInstanceWitness]:
    snaps = tracer.vm_snapshots
    assert snaps, "tracer recorded no snapshots"
    total_cycles = tracer.cycle_counter
    log_entries = tracer.final_log_queue()
    out = []
    for i, snap in enumerate(snaps):
        lo = snap.cycle
        hi = snaps[i + 1].cycle if i + 1 < len(snaps) else total_cycles
        out.append(VmInstanceWitness(
            index=i,
            start_flag=(i == 0),
            completion_flag=(i == len(snaps) - 1),
            cycle_range=(lo, hi),
            initial_state=snap.state_repr,
            final_state=(snaps[i + 1].state_repr if i + 1 < len(snaps)
                         else None),
            queue_slices=QueueSlices(
                memory=_range_for(tracer.memory_queries, lo, hi),
                logs=_range_for(log_entries, lo, hi),
                decommits=_range_for(tracer.decommittment_queries, lo, hi))))
    return out
