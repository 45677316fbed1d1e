"""Pod-level proof-DAG scheduler: base -> leaf -> node -> scheduler pipeline.

Counterpart of the JAX package's `prover/scheduler.py`. On one card the
harness runs the DAG with `max_workers=1`: threads gain nothing there.

The reference runs the aggregation pipeline sequentially in one process with
filesystem hand-off (SURVEY §2d "Pipeline"); here the pipeline is an explicit
DAG of proof tasks with:
  - data-source guarded execution (skip-if-present resume, matching the
    reference's `if source.get_X().is_err() { compute; set_X }` protocol —
    complex_tests/mod.rs:323-331);
  - ready-set scheduling so independent tasks (all base instances, all leaf
    chunks) can be dispatched to parallel workers/chips;
  - pluggable `prove_fn(task) -> proof` so the same DAG drives real proving,
    satisfiability-only checks, or dry runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..circuits.types import RecursionLayerCircuitType
from ..utils.data_source import InMemoryDataSource
from ..witness.recursion import (aggregate_to_single_node,
                                 create_leaf_witnesses)
from ..witness.queues import QueueSimulator


@dataclasses.dataclass(frozen=True)
class ProofTask:
    kind: str  # "base" | "leaf" | "node" | "scheduler"
    circuit_type: int
    index: int
    depth: int = 0
    deps: Tuple["ProofTask", ...] = ()
    payload: object = None

    def key(self):
        return (self.kind, self.circuit_type, self.depth, self.index)


def build_block_dag(recursion_queues: Dict[int, QueueSimulator],
                    num_base_instances: Dict[int, int],
                    leaf_arity: int = None) -> List[ProofTask]:
    """Build the full aggregation DAG for one block.

    recursion_queues: base_circuit_type -> queue of recursion requests
    num_base_instances: base_circuit_type -> number of base circuit instances
    leaf_arity: proofs per leaf chunk (None = RECURSION_ARITY = 32)
    Returns tasks in a valid topological order (scheduler last). Types with
    EMPTY queues contribute no tasks and no scheduler dependency (the
    reference feeds those slots padding proofs; at this scale the scheduler
    is synthesized over the present types).
    """
    from ..witness.recursion import RECURSION_ARITY
    leaf_arity = leaf_arity or RECURSION_ARITY
    tasks: List[ProofTask] = []
    final_nodes: List[ProofTask] = []
    for base_type in sorted(recursion_queues):
        queue = recursion_queues[base_type]
        n_inst = num_base_instances.get(base_type, len(queue))
        if n_inst == 0 or len(queue) == 0:
            continue
        base_tasks = [ProofTask("base", base_type, i) for i in range(n_inst)]
        tasks.extend(base_tasks)
        leaf_wits = create_leaf_witnesses(base_type, queue,
                                          arity=leaf_arity)
        leaf_tasks = []
        for lw in leaf_wits:
            deps = tuple(base_tasks[j] for j in lw.proof_indices)
            leaf_tasks.append(ProofTask("leaf", lw.circuit_type, lw.index,
                                        deps=deps, payload=lw))
        tasks.extend(leaf_tasks)
        levels = aggregate_to_single_node(base_type, leaf_wits)
        prev_tasks: Sequence[ProofTask] = leaf_tasks
        for depth, level in enumerate(levels):
            node_tasks = []
            for nw in level:
                deps = tuple(prev_tasks[j] for j in
                             range(nw.index * 32, min((nw.index + 1) * 32,
                                                      len(prev_tasks))))
                node_tasks.append(ProofTask("node", base_type, nw.index,
                                            depth=depth, deps=deps, payload=nw))
            tasks.extend(node_tasks)
            prev_tasks = node_tasks
        final_nodes.append(prev_tasks[0])
    tasks.append(ProofTask("scheduler", int(RecursionLayerCircuitType.SCHEDULER),
                           0, deps=tuple(final_nodes)))
    return tasks


def stored_record(source, t: ProofTask):
    """The record of task `t` in `source`, or None."""
    if t.kind == "base":
        return source.get_base_layer_proof(t.circuit_type, t.index)
    if t.kind == "leaf":
        return source.get_leaf_layer_proof(t.circuit_type, t.index)
    if t.kind == "node":
        return source.get_node_layer_proof(t.circuit_type, t.depth, t.index)
    return source.get_scheduler_proof()


def store_record(source, t: ProofTask, proof) -> None:
    """`proof`, the record of task `t`, into `source`."""
    if t.kind == "base":
        source.set_base_layer_proof(proof, t.circuit_type, t.index)
    elif t.kind == "leaf":
        source.set_leaf_layer_proof(proof, t.circuit_type, t.index)
    elif t.kind == "node":
        source.set_node_layer_proof(proof, t.circuit_type, t.depth, t.index)
    else:
        source.set_scheduler_proof(proof)


def run_dag(tasks: List[ProofTask], prove_fn: Callable[[ProofTask, Dict], object],
            source: Optional[InMemoryDataSource] = None,
            progress: Optional[Callable[[str], None]] = None,
            max_workers: int = 1) -> Dict:
    """Execute the DAG with resume semantics. Returns key -> proof.

    max_workers > 1 dispatches each `ready_batches` wave through a thread
    pool — instance-level data parallelism over independent proofs (all base
    instances, all leaf chunks; the reference runs these sequentially,
    complex_tests/mod.rs:316-407). Results and resume behavior are identical
    to the sequential path: every task is still store-guarded and its
    dependencies are complete before its wave starts.
    """
    source = source or InMemoryDataSource()
    done: Dict = {}

    def run_one(t: ProofTask):
        existing = stored_record(source, t)
        if existing is not None:
            return t, existing, True
        assert all(d.key() in done for d in t.deps), "DAG order violated"
        proof = prove_fn(t, {d.key(): done[d.key()] for d in t.deps})
        return t, proof, False

    def record(t: ProofTask, proof, resumed: bool):
        if not resumed:
            store_record(source, t, proof)
        done[t.key()] = proof
        if progress and not resumed:
            progress(f"{t.kind}[{t.circuit_type}][d{t.depth}][{t.index}] done")

    if max_workers <= 1:
        for t in tasks:
            record(*run_one(t))
        return done

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for wave in ready_batches(tasks):
            for t, proof, resumed in pool.map(run_one, wave):
                record(t, proof, resumed)
    return done


def ready_batches(tasks: List[ProofTask]) -> List[List[ProofTask]]:
    """Group tasks into maximal parallel waves (for multi-chip dispatch)."""
    level: Dict[Tuple, int] = {}
    for t in tasks:
        level[t.key()] = 1 + max((level[d.key()] for d in t.deps), default=-1)
    waves: Dict[int, List[ProofTask]] = {}
    for t in tasks:
        waves.setdefault(level[t.key()], []).append(t)
    return [waves[k] for k in sorted(waves)]
