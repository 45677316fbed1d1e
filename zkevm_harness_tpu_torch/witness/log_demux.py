"""Log-demuxer witness decomposer (circuit type 4): per-instance payloads
for the demux circuit.

Mirrors compute_logs_demux (src/witness/individual_circuits/log_demux.rs:20):
one instance consumes a segment of the rollback-resolved log queue and
routes every element into exactly one of SIX output queues — storage /
events / L1 messages / keccak / sha256 / ecrecover (demux_log_queue rules,
witness/oracle.py) — recording the narrow queue states of all seven queues
at the instance boundaries for FSM chaining.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..vm.environment import (AUX_BYTE_EVENT, AUX_BYTE_L1_MESSAGE,
                              AUX_BYTE_PRECOMPILE, AUX_BYTE_STORAGE,
                              DefaultPrecompilesProcessor, LogQuery)
from .encodings import encode_log_query
from .queues import QueueSimulator

CLASS_NAMES = ("storage", "events", "l1", "keccak", "sha256", "ecrecover")
NUM_CLASSES = 6
ENC_W = 20


def classify(q: LogQuery) -> int:
    if q.aux_byte == AUX_BYTE_STORAGE:
        return 0
    if q.aux_byte == AUX_BYTE_EVENT:
        return 1
    if q.aux_byte == AUX_BYTE_L1_MESSAGE:
        return 2
    assert q.aux_byte == AUX_BYTE_PRECOMPILE, q.aux_byte
    if q.address == DefaultPrecompilesProcessor.KECCAK_ADDRESS:
        return 3
    if q.address == DefaultPrecompilesProcessor.SHA256_ADDRESS:
        return 4
    return 5


@dataclasses.dataclass
class DemuxCircuitInstance:
    index: int
    start_flag: bool
    completion_flag: bool
    input_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    output_queue_states: Tuple  # 6 x (head, tail, count)
    num_items_in: int
    num_items: int
    out_items_in: Tuple[int, ...]   # 6
    out_items: Tuple[int, ...]      # 6
    encodings: np.ndarray           # (num_items, 20)
    classes: np.ndarray             # (num_items,)


@dataclasses.dataclass
class DemuxCircuitArtifacts:
    circuit_type: int
    instances: List[DemuxCircuitInstance]
    output_queues: Tuple[QueueSimulator, ...]  # 6


def compute_log_demux_artifacts(queries: Sequence[LogQuery],
                                capacity: int,
                                device=None) -> DemuxCircuitArtifacts:
    """The queue chains run on `device` (`None` means the CUDA card)."""
    n = len(queries)
    enc = np.array([encode_log_query(q) for q in queries],
                   dtype=object).reshape(-1, ENC_W)
    classes = np.array([classify(q) for q in queries], dtype=np.int64)

    in_q = QueueSimulator(device=device)
    in_q.push_many(enc)
    in_tails = in_q.tails()

    out_qs = tuple(QueueSimulator(device=device) for _ in range(NUM_CLASSES))
    for k in range(NUM_CLASSES):
        out_qs[k].push_many([enc[i] for i in range(n) if classes[i] == k])
    out_tails = [q.tails() for q in out_qs]
    # per-class prefix counts at every input position
    prefix = np.zeros((n + 1, NUM_CLASSES), dtype=np.int64)
    for i in range(n):
        prefix[i + 1] = prefix[i]
        prefix[i + 1][classes[i]] += 1

    bounds = list(range(0, n, capacity)) + [n]
    if n == 0:
        bounds = [0, 0]
    instances = []
    n_inst = len(bounds) - 1
    for i in range(n_inst):
        lo, hi = bounds[i], bounds[i + 1]
        states = []
        for k in range(NUM_CLASSES):
            olo, ohi = int(prefix[lo][k]), int(prefix[hi][k])
            states.append((tuple(int(v) for v in out_tails[k][olo]),
                           tuple(int(v) for v in out_tails[k][ohi]),
                           ohi - olo))
        instances.append(DemuxCircuitInstance(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            input_queue_state=(tuple(int(v) for v in in_tails[lo]),
                               tuple(int(v) for v in in_tails[hi]), hi - lo),
            output_queue_states=tuple(states),
            num_items_in=lo, num_items=hi - lo,
            out_items_in=tuple(int(prefix[lo][k]) for k in range(NUM_CLASSES)),
            out_items=tuple(int(prefix[hi][k] - prefix[lo][k])
                            for k in range(NUM_CLASSES)),
            encodings=enc[lo:hi], classes=classes[lo:hi]))
    return DemuxCircuitArtifacts(circuit_type=4, instances=instances,
                                 output_queues=out_qs)
