"""L1-messages linear hasher witness (circuit type 13).

Parity with `compute_linear_keccak256`
(src/witness/individual_circuits/data_hasher_and_merklizer.rs:8, SURVEY
component 7): consume the deduplicated L1-message queue, hash the serialized
messages with keccak256 (one linear pass), and emit the instance witness
binding the input queue state to the output hash. Capacity
limit_for_l1_messages_pudata_hasher = 774 messages per 2^20-row instance.

Counterpart of the JAX package's `witness/linear_hasher.py`; the queue
simulator and the challenges run on the `device` each entry point takes
(`None` means the CUDA card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..utils.native import keccak256
from ..vm.environment import LogQuery
from .encodings import (L2_TO_L1_MESSAGE_BYTE_LENGTH, encode_log_query,
                        serialize_l2_to_l1_message)
from .queues import QueueSimulator

L1_MESSAGE_SERIALIZED_LEN = L2_TO_L1_MESSAGE_BYTE_LENGTH  # 88


def serialize_l1_message(q: LogQuery) -> bytes:
    """Reference byte serialization (log_query.rs:503-534): shard |
    is_service | tx(2,BE) | address(20) | key(32) | written_value(32)."""
    return serialize_l2_to_l1_message(q)


@dataclasses.dataclass
class LinearHasherInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    input_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    output_hash: bytes  # only meaningful on the completion instance


@dataclasses.dataclass
class LinearHasherCircuitArtifacts:
    """Circuit-level payloads for type 13: ONE in-circuit keccak256 of the
    serialized message stream (circuits/linear_hasher_circuit.py proves the
    full chained sponge; the reference capacity of 774 messages per
    instance always fits one)."""
    instances: List  # [HasherInstanceInputs]
    digest: bytes
    queue_instances: List[LinearHasherInstanceWitness]


def compute_hasher_circuit_artifacts(messages: Sequence[LogQuery],
                                     capacity: int, device=None
                                     ) -> LinearHasherCircuitArtifacts:
    from ..circuits import linear_hasher_circuit as lh
    assert len(messages) <= capacity, \
        "multi-instance linear hashing exceeds the single-hash capacity"
    data = b"".join(serialize_l1_message(q) for q in messages)
    queue_instances, digest = compute_linear_keccak256(messages, capacity,
                                                       device=device)
    inst = lh.instance_inputs(data, device=device)
    return LinearHasherCircuitArtifacts(
        instances=[inst], digest=digest, queue_instances=queue_instances)


def compute_linear_keccak256(messages: Sequence[LogQuery], capacity: int,
                             device=None
                             ) -> Tuple[List[LinearHasherInstanceWitness], bytes]:
    data = b"".join(serialize_l1_message(q) for q in messages)
    final_hash = keccak256(data)
    queue = QueueSimulator(device=device)
    queue.push_many([encode_log_query(q) for q in messages])
    tails = queue.tails()
    n = len(messages)
    n_inst = max(1, -(-n // capacity)) if n else 1
    instances = []
    for i in range(n_inst):
        lo, hi = i * capacity, min(n, (i + 1) * capacity)
        instances.append(LinearHasherInstanceWitness(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            input_queue_state=(tuple(int(v) for v in tails[lo]),
                               tuple(int(v) for v in tails[min(hi, n)]),
                               max(0, hi - lo)),
            output_hash=final_hash if i == n_inst - 1 else b""))
    return instances, final_hash
