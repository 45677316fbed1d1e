"""Recursive-aggregation witness builders: leaf -> node -> scheduler.

Counterpart of the JAX package's `witness/recursion.py`, whole. Parity with src/witness/recursive_aggregation.rs (SURVEY L5):
  - `create_leaf_witnesses` splits each per-circuit-type recursion queue into
    chunks of RECURSION_ARITY = 32 and forms one leaf aggregation task per
    chunk (recursive_aggregation.rs:71-161);
  - `create_node_witnesses` merges up to 32 child queues per node circuit,
    recording the split points (recursive_aggregation.rs:270-421);
  - `compute_leaf_params` / VK commitments are Poseidon2 digests of the
    verification keys (recursive_aggregation.rs:163-267 — the reference runs
    a throwaway CS; here the commitment is a direct sponge hash, which plays
    the same role of binding leaf VKs into node/scheduler public inputs).

The in-circuit verifier gadget (proving "I verified these 32 proofs") layers
on the PLONKish engine in a later increment; these builders define the data
flow and the pod-level DAG of the aggregation tower. The recursion queue
chains and the VK commitments run on `device` (`None`: the CUDA card,
raising where there is none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..circuits.types import (BaseLayerCircuitType, RECURSION_ARITY,
                              RecursionLayerCircuitType, leaf_for)
from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from .queues import FullWidthQueueSimulator, QueueSimulator

P = gl.P


@dataclasses.dataclass(frozen=True)
class RecursionRequest:
    """One aggregation request (circuit_encodings recursion_request.rs:5-28)."""

    circuit_type: int
    public_input: Tuple[int, int, int, int]

    def encode(self) -> List[int]:
        return [self.circuit_type, *self.public_input, 0, 0, 0]


class RecursionQueueSimulator(FullWidthQueueSimulator):
    """Full-width (12-element state) queue of recursion requests
    (recursion_request.rs:40-46)."""

    def push_request(self, req: RecursionRequest):
        self.push(req.encode())


@dataclasses.dataclass
class LeafAggregationTask:
    circuit_type: int  # recursion-layer type (leaf_for(base))
    base_circuit_type: int
    index: int
    queue_head: Tuple[int, ...]
    queue_tail: Tuple[int, ...]
    num_items: int
    encodings: np.ndarray  # (<=32, 8)
    proof_indices: List[int]  # indices of base proofs aggregated here


@dataclasses.dataclass
class NodeAggregationTask:
    circuit_type: int  # == RecursionLayerCircuitType.NODE
    base_circuit_type: int
    depth: int
    index: int
    child_is_leaf: bool
    child_indices: List[int]
    queue_head: Tuple[int, ...]
    queue_tail: Tuple[int, ...]
    num_items: int


def create_leaf_witnesses(base_type: int, queue: QueueSimulator,
                          arity: int = RECURSION_ARITY
                          ) -> List[LeafAggregationTask]:
    """Split one base type's recursion queue into leaf tasks of ARITY items."""
    chunks = queue.split_by(arity)
    tasks = []
    proof_cursor = 0
    for i, chunk in enumerate(chunks):
        k = len(chunk)
        tasks.append(LeafAggregationTask(
            circuit_type=int(leaf_for(BaseLayerCircuitType(base_type))),
            base_circuit_type=base_type,
            index=i,
            queue_head=tuple(chunk.head),
            queue_tail=chunk.tail,
            num_items=k,
            encodings=chunk.encodings,
            proof_indices=list(range(proof_cursor, proof_cursor + k)),
        ))
        proof_cursor += k
    return tasks


def create_node_witnesses(base_type: int, depth: int,
                          children: Sequence) -> List[NodeAggregationTask]:
    """Merge up to ARITY children per node; children are leaf or node tasks."""
    tasks = []
    for i in range(0, len(children), RECURSION_ARITY):
        group = children[i:i + RECURSION_ARITY]
        tasks.append(NodeAggregationTask(
            circuit_type=int(RecursionLayerCircuitType.NODE),
            base_circuit_type=base_type,
            depth=depth,
            index=i // RECURSION_ARITY,
            child_is_leaf=(depth == 0),
            child_indices=[c.index for c in group],
            queue_head=tuple(group[0].queue_head),
            queue_tail=tuple(group[-1].queue_tail),
            num_items=sum(c.num_items for c in group),
        ))
    return tasks


def aggregate_to_single_node(base_type: int,
                             leaf_tasks: List[LeafAggregationTask]
                             ) -> List[List[NodeAggregationTask]]:
    """Repeat node aggregation until one task remains; returns per-depth lists
    (the reference's per-type NODE AGGREGATION LOOP,
    complex_tests/mod.rs:797-945)."""
    levels: List[List[NodeAggregationTask]] = []
    current: Sequence = leaf_tasks
    depth = 0
    while True:
        nodes = create_node_witnesses(base_type, depth, current)
        levels.append(nodes)
        if len(nodes) == 1:
            return levels
        current = nodes
        depth += 1


# ---------------------------------------------------------------------------
# VK commitments (leaf params / node vk commitment)
# ---------------------------------------------------------------------------

def commit_vk(vk_ints: Sequence[int], device=None
              ) -> Tuple[int, int, int, int]:
    """Poseidon2 digest of a verification key's field-element encoding."""
    digest = p2.hash_elements(gl.from_int([int(v) % P for v in vk_ints],
                                          device))
    return tuple(int(v) for v in gl.to_ints(digest))


def compute_leaf_params(leaf_vks: Dict[int, Sequence[int]], device=None
                        ) -> List[Tuple[int, Tuple[int, int, int, int]]]:
    """(base_circuit_type, vk_commitment) per type, ordered by type id
    (recursive_aggregation.rs:163-222)."""
    return [(t, commit_vk(vk, device)) for t, vk in sorted(leaf_vks.items())]


def compute_leaf_vks_and_params_commitment(
        leaf_params: List[Tuple[int, Tuple[int, int, int, int]]],
        device=None) -> Tuple[int, int, int, int]:
    flat: List[int] = []
    for t, com in leaf_params:
        flat.append(t)
        flat.extend(com)
    return commit_vk(flat, device)


def compute_node_vk_commitment(node_vk: Sequence[int], device=None
                               ) -> Tuple[int, int, int, int]:
    return commit_vk(node_vk, device)
