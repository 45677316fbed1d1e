"""Scheduler-circuit witness assembly (block-level glue).

Counterpart of the JAX package's `witness/scheduler_witness.py` (host ints
and bytes only).

Parity with the scheduler-witness skeleton built at the end of
`external_calls::run` (src/external_calls.rs:250-540, SURVEY stack 3.2):
queue-state commitments (events queue, bootloader heap initial content),
per-circuit first/last closed-form inputs, block aux output (state diffs,
L1 messages linear hash), and the recursion parameters patched in later
(node VK, leaf params, node proofs — complex_tests/mod.rs:948-975).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..utils.native import keccak256
from .oracle import BlockArtifacts
from .postprocessing import CircuitInstance
from .queues import QueueState


@dataclasses.dataclass
class BlockAuxilaryOutput:
    rollup_state_diff_for_compression: bytes  # keccak over net storage diffs
    l1_messages_linear_hash: bytes  # keccak over net L1 messages
    events_queue_state: QueueState


@dataclasses.dataclass
class SchedulerCircuitInstanceWitness:
    block_number: int
    bootloader_heap_initial_content: Tuple[int, ...]  # queue-tail commitment
    events_queue_state: QueueState
    memory_queue_state: QueueState
    first_last_closed_form_inputs: Dict[int, Tuple[object, object]]
    aux_output: BlockAuxilaryOutput
    # EIP-4844 blob output commitments (keccak(versioned_hash ||
    # evaluation_point || opening_value) per blob) — absorbed into the
    # scheduler's block commitment (complex_tests/mod.rs:995-1075)
    eip4844_output_hashes: Tuple[bytes, ...] = ()
    # patched in after recursion proving (complex_tests/mod.rs:948-975):
    node_layer_vk_commitment: Optional[Tuple[int, int, int, int]] = None
    leaf_layer_parameters: Optional[List] = None
    node_proof_witnesses: Optional[List] = None

    def patch_recursion(self, node_vk_commitment, leaf_params, node_proofs):
        self.node_layer_vk_commitment = tuple(node_vk_commitment)
        self.leaf_layer_parameters = list(leaf_params)
        self.node_proof_witnesses = list(node_proofs)

    def is_complete(self) -> bool:
        return (self.node_layer_vk_commitment is not None
                and self.leaf_layer_parameters is not None
                and self.node_proof_witnesses is not None)


def _hash_log_queries(queries) -> bytes:
    data = b"".join(
        q.address.to_bytes(20, "big") + q.key.to_bytes(32, "big")
        + q.written_value.to_bytes(32, "big") for q in queries)
    return keccak256(data)


def assemble_scheduler_witness(
        block_number: int, artifacts: BlockArtifacts,
        first_last: Dict[int, Tuple[CircuitInstance, CircuitInstance]],
        bootloader_heap_tail: Tuple[int, ...] = (0,) * 12,
        eip4844_output_hashes: Tuple[bytes, ...] = (),
) -> SchedulerCircuitInstanceWitness:
    aux = BlockAuxilaryOutput(
        rollup_state_diff_for_compression=_hash_log_queries(
            artifacts.deduplicated_storage),
        l1_messages_linear_hash=_hash_log_queries(
            artifacts.deduplicated_l1_messages),
        events_queue_state=QueueState(tail=tuple(artifacts.log_queue.tail),
                                      length=len(artifacts.log_queue)))
    return SchedulerCircuitInstanceWitness(
        block_number=block_number,
        bootloader_heap_initial_content=tuple(bootloader_heap_tail),
        events_queue_state=aux.events_queue_state,
        memory_queue_state=QueueState(tail=tuple(artifacts.memory_queue.tail),
                                      length=len(artifacts.memory_queue)),
        first_last_closed_form_inputs=dict(first_last),
        aux_output=aux,
        eip4844_output_hashes=tuple(eip4844_output_hashes))
