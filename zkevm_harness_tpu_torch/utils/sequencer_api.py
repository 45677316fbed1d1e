"""Sequencer-facing API: the thin surface zksync-era's sequencer consumes.

Counterpart of the JAX package's `utils/sequencer_api.py`. Parity with the `circuit_sequencer_api` crate (SURVEY §2b): queue-commitment
helpers (`events_queue_commitment`, `initial_heap_content_commitment` —
utils.rs:11-68, commitments.rs:11-74), the storage-access sort/dedup re-export
(sort_storage_access.rs — implemented in witness/storage_sort.py), and the
GeometryConfig re-export (circuits/types.py). The commitments take
`device`: `None` means the CUDA card (raises where there is none).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..circuits.types import GeometryConfig  # re-export (sequencer surface)
from ..vm.environment import LogQuery
from ..witness.encodings import encode_log_query, encode_memory_query
from ..witness.queues import FullWidthQueueSimulator, QueueSimulator
from ..witness.storage_sort import sort_storage_access_queries  # re-export


def events_queue_commitment(events: Sequence[LogQuery],
                            device=None) -> Tuple[int, ...]:
    """Poseidon2 queue-tail commitment of the (deduplicated) events queue
    (commitments.rs events_queue_commitment_fixed)."""
    q = QueueSimulator(device=device)
    q.push_many([encode_log_query(e) for e in events])
    return q.tail


def initial_heap_content_commitment(heap_words: Sequence[int],
                                    device=None) -> Tuple[int, ...]:
    """Commitment to the bootloader heap's initial content: the memory-write
    queue tail for the nondeterministic heap preload
    (commitments.rs initial_heap_content_commitment_fixed; memory queues are
    full-width — memory_query.rs:120-128)."""
    from ..vm.environment import MemoryLocation, MemoryQuery
    q = FullWidthQueueSimulator(device=device)
    q.push_many([
        encode_memory_query(MemoryQuery(
            timestamp=0, location=MemoryLocation(2, i),
            value=int(w) & ((1 << 256) - 1), rw_flag=True))
        for i, w in enumerate(heap_words)])
    return q.tail
