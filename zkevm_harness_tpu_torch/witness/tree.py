"""Depth-256 sparse binary storage Merkle tree (Blake2s), enumeration indices.

Counterpart of the JAX package's `witness/tree.py`, as it is: host Python
over `hashlib.blake2s`.

Behavioral parity with the reference's `BinarySparseStorageTree` /
`InMemoryStorageTree` / `ZKSyncTestingTree` (src/witness/tree/mod.rs:3-834,
SURVEY component 10):
  - leaf hash = blake2s(enum_index_u64_be || value_32)  (40 bytes)
  - node hash = blake2s(left || right)
  - path bit at level L is bit L of the 32-byte index in little-endian
    byte/bit order (index[L//8] >> (L%8) & 1); bit set => leaf on the right
  - enumeration indices start at 1; `filter_renumerate` splits a write batch
    into first-writes (assigned fresh indices) vs updates (keep index)
  - default subtree hashes precomputed per level for the sparse layout.

Design note: indexes are python ints internally (little-endian value of the
32-byte key) with conversion at the API edge.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

DEPTH = 256
INDEX_BYTES = 32


def blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def leaf_hash(enum_index: int, value: bytes) -> bytes:
    assert len(value) == 32
    return blake2s(enum_index.to_bytes(8, "big") + value)


def node_hash(left: bytes, right: bytes) -> bytes:
    return blake2s(left + right)


def index_to_int(index: bytes) -> int:
    return int.from_bytes(index, "little")


def index_to_bytes(index: int) -> bytes:
    return index.to_bytes(INDEX_BYTES, "little")


@dataclasses.dataclass
class StorageLeaf:
    """ZkSyncStorageLeaf: 32-byte value + u64 enumeration index."""

    value: bytes = b"\x00" * 32
    index: int = 0


@dataclasses.dataclass
class LeafQuery:
    leaf: StorageLeaf
    first_write: bool
    index: bytes
    merkle_path: List[bytes]  # DEPTH sibling hashes, leaf level first


class SparseStorageTree:
    """In-memory sparse tree; only touched nodes are materialized.

    `depth` defaults to the production 256; reduced depths give the SAME
    hashing rules over a shallower tree (the testing-geometry analogue for
    the type-10 circuit, whose per-path cost is depth-proportional)."""

    def __init__(self, depth: int = DEPTH):
        self.depth = depth
        self.next_enumeration_index = 1
        self.leafs: Dict[int, StorageLeaf] = {}
        self.layers: List[Dict[int, bytes]] = [dict() for _ in range(depth)]
        self.empty_hashes: List[bytes] = []
        cur = leaf_hash(0, b"\x00" * 32)
        for _ in range(depth):
            self.empty_hashes.append(cur)
            cur = node_hash(cur, cur)
        self.root = cur

    def _node(self, level: int, idx: int) -> bytes:
        key = idx >> level  # normalize: drop the low bits below this level
        return self.layers[level].get(key, self.empty_hashes[level])

    def _set_node(self, level: int, idx: int, value: bytes):
        self.layers[level][idx >> level] = value

    def _idx(self, index: bytes) -> int:
        # reduced-depth trees address by the low `depth` bits (a leaf's
        # position); at the production 256 this is the full index
        return index_to_int(index) & ((1 << self.depth) - 1)

    def get_leaf(self, index: bytes) -> LeafQuery:
        idx = self._idx(index)
        leaf = self.leafs.get(idx, StorageLeaf())
        path = [self._node(level, idx ^ (1 << level))
                for level in range(self.depth)]
        return LeafQuery(leaf=leaf, first_write=False, index=index,
                         merkle_path=path)

    def insert_leaf(self, index: bytes, value: bytes) -> LeafQuery:
        idx = self._idx(index)
        first_write = idx not in self.leafs
        if first_write:
            self.leafs[idx] = StorageLeaf(value=value,
                                          index=self.next_enumeration_index)
            self.next_enumeration_index += 1
        else:
            self.leafs[idx].value = value
        leaf = self.leafs[idx]
        cur = leaf_hash(leaf.index, leaf.value)
        path = []
        for level in range(self.depth):
            self._set_node(level, idx, cur)
            sib = self._node(level, idx ^ (1 << level))
            path.append(sib)
            if (idx >> level) & 1:
                cur = node_hash(sib, cur)
            else:
                cur = node_hash(cur, sib)
        self.root = cur
        return LeafQuery(leaf=leaf, first_write=first_write, index=index,
                         merkle_path=path)

    def insert_many(self, indexes: Sequence[bytes], values: Sequence[bytes]
                    ) -> List[LeafQuery]:
        return [self.insert_leaf(i, v) for i, v in zip(indexes, values)]

    def filter_renumerate(self, indexes: Iterable[bytes],
                          values: Iterable[bytes]
                          ) -> Tuple[int, List[Tuple[bytes, StorageLeaf]],
                                     List[StorageLeaf]]:
        """Split a write batch into (next_index, first_writes, updates)
        without mutating the tree (src/witness/tree/mod.rs filter_renumerate)."""
        first_writes = []
        updates = []
        next_index = self.next_enumeration_index
        for index, value in zip(indexes, values):
            idx = self._idx(index)
            existing = self.leafs.get(idx)
            if existing is not None:
                updates.append(StorageLeaf(value=value, index=existing.index))
            else:
                first_writes.append((index, StorageLeaf(value=value,
                                                        index=next_index)))
                next_index += 1
        return next_index, first_writes, updates

    @staticmethod
    def verify_inclusion(root: bytes, query: LeafQuery) -> bool:
        idx = index_to_int(query.index)  # low bits drive the path walk
        cur = leaf_hash(query.leaf.index, query.leaf.value)
        for level in range(len(query.merkle_path)):
            sib = query.merkle_path[level]
            if (idx >> level) & 1:
                cur = node_hash(sib, cur)
            else:
                cur = node_hash(cur, sib)
        return cur == root
