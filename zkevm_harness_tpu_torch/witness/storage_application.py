"""Storage-application witness: apply deduplicated writes to the state tree.

Counterpart of the JAX package's `witness/storage_application.py`, as it
is.

Parity with `decompose_into_storage_application_witnesses`
(src/witness/individual_circuits/storage_application.rs:31, SURVEY component
7): consume the deduplicated storage queue in order; for every query capture
the Merkle read path (pre-state), apply writes through the depth-256 sparse
tree (first-write enumeration via filter_renumerate semantics), and record
the per-query leaf/path witnesses. Split into instances of the geometry
capacity (cycles_per_storage_application = 33) carrying root-hash FSM
continuation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..vm.environment import LogQuery
from .tree import SparseStorageTree


def storage_key_to_index(address: int, key: int) -> bytes:
    """Derive the 32-byte tree index from (address, key).

    The reference derives leaf indexes from hashed (address, key) pairs; this
    framework uses blake2s(address_be20 || key_be32) — one stable convention,
    swappable at this single point.
    """
    from .tree import blake2s
    return blake2s(address.to_bytes(20, "big") + key.to_bytes(32, "big"))


@dataclasses.dataclass
class StorageApplicationQueryWitness:
    query: LogQuery
    index: bytes
    read_path: List[bytes]  # pre-state sibling path
    leaf_before: Tuple[int, bytes]  # (enum_index, value)
    leaf_after: Tuple[int, bytes]
    first_write: bool


@dataclasses.dataclass
class StorageApplicationInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    initial_root: bytes
    final_root: bytes
    initial_next_enumeration_index: int
    final_next_enumeration_index: int
    queries: List[StorageApplicationQueryWitness]


def path_circuit_instances(qw: "StorageApplicationQueryWitness"):
    """Bridge one query witness into (read, write) circuit payloads for
    circuits/storage_application_circuit.py — the read path proves the
    pre-state leaf under the pre-root, the write path proves the post
    leaf under the post-root with the SAME siblings."""
    from ..circuits.storage_application_circuit import PathInstanceInputs
    from .tree import index_to_int
    idx = index_to_int(qw.index)
    depth = len(qw.read_path)  # tree depth (production 256; tests reduce)
    bits = [(idx >> level) & 1 for level in range(depth)]
    read_inst = PathInstanceInputs(
        leaf_preimage=(qw.leaf_before[0].to_bytes(8, "big")
                       + qw.leaf_before[1]),
        path_bits=bits, siblings=list(qw.read_path))
    write_inst = PathInstanceInputs(
        leaf_preimage=(qw.leaf_after[0].to_bytes(8, "big")
                       + qw.leaf_after[1]),
        path_bits=bits, siblings=list(qw.read_path))
    return read_inst, write_inst


@dataclasses.dataclass
class StorageApplicationCircuitArtifacts:
    """Per-query circuit payloads (type 10) + the root chain they prove."""
    instances: List  # [(read PathInstanceInputs, write PathInstanceInputs)]
    initial_root: bytes
    final_root: bytes
    query_witnesses: List["StorageApplicationInstanceWitness"]


def compute_storage_application_artifacts(
        tree: "SparseStorageTree", dedup_queries: Sequence[LogQuery],
        capacity: int) -> StorageApplicationCircuitArtifacts:
    initial_root = tree.root
    insts = decompose_into_storage_application_witnesses(
        tree, dedup_queries, capacity)
    pairs = []
    for iw in insts:
        for qw in iw.queries:
            pairs.append(path_circuit_instances(qw))
    return StorageApplicationCircuitArtifacts(
        instances=pairs, initial_root=initial_root, final_root=tree.root,
        query_witnesses=insts)


def decompose_into_storage_application_witnesses(
        tree: SparseStorageTree, dedup_queries: Sequence[LogQuery],
        capacity: int) -> List[StorageApplicationInstanceWitness]:
    n = len(dedup_queries)
    n_inst = max(1, -(-n // capacity)) if n else 0
    instances = []
    qi = 0
    for i in range(n_inst):
        initial_root = tree.root
        initial_enum = tree.next_enumeration_index
        chunk = []
        for q in dedup_queries[i * capacity:(i + 1) * capacity]:
            index = storage_key_to_index(q.address, q.key)
            before = tree.get_leaf(index)
            assert SparseStorageTree.verify_inclusion(tree.root, before)
            if q.rw_flag:
                after = tree.insert_leaf(index,
                                         q.written_value.to_bytes(32, "big"))
                leaf_after = (after.leaf.index, after.leaf.value)
                first_write = after.first_write
            else:
                # protective read: state unchanged
                assert int.from_bytes(before.leaf.value, "big") == q.read_value
                leaf_after = (before.leaf.index, before.leaf.value)
                first_write = False
            chunk.append(StorageApplicationQueryWitness(
                query=q, index=index, read_path=before.merkle_path,
                leaf_before=(before.leaf.index, before.leaf.value),
                leaf_after=leaf_after, first_write=first_write))
            qi += 1
        instances.append(StorageApplicationInstanceWitness(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            initial_root=initial_root, final_root=tree.root,
            initial_next_enumeration_index=initial_enum,
            final_next_enumeration_index=tree.next_enumeration_index,
            queries=chunk))
    return instances
