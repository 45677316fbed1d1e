"""Poseidon2 Merkle tree with cap, batched per level (PyTorch).

Counterpart of the JAX package's `ops/merkle.py`. Each level is one batched
Poseidon2 call over all its nodes. Digests are 4 Goldilocks elements. The
tree stops at `cap_size` nodes; the cap (all nodes at that level) is the
commitment absorbed into the transcript.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon2 as p2
from .goldilocks import GF

DIGEST_WIDTH = 4


class MerkleTree(NamedTuple):
    # levels[0] = leaf digests (n, 4); levels[-1] = cap (cap_size, 4)
    levels: Tuple[GF, ...]

    @property
    def cap(self) -> GF:
        return self.levels[-1]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1


def hash_leaves(rows: GF) -> GF:
    """(n, w) leaf rows -> (n, 4) leaf digests (one batched sponge)."""
    return p2.hash_elements(rows)


def commit(rows: GF, cap_size: int) -> MerkleTree:
    """Leaf hashing + full tree build."""
    return build_tree(hash_leaves(rows), cap_size)


def build_tree(leaf_digests: GF, cap_size: int) -> MerkleTree:
    n = leaf_digests.shape[0]
    assert n & (n - 1) == 0 and cap_size & (cap_size - 1) == 0
    assert n >= cap_size
    levels: List[GF] = [leaf_digests]
    cur = leaf_digests
    while cur.shape[0] > cap_size:
        pairs = cur.reshape(cur.shape[0] // 2, 2, DIGEST_WIDTH)
        cur = p2.hash_two_to_one(pairs[:, 0, :], pairs[:, 1, :])
        levels.append(cur)
    return MerkleTree(tuple(levels))


def open_indices(tree: MerkleTree, indices: np.ndarray) -> GF:
    """Sibling digests along the paths for `indices` -> (q, depth, 4)."""
    device = tree.levels[0].device
    cur = torch.from_numpy(np.asarray(indices).astype(np.int64)).to(device)
    sibs = []
    for level in tree.levels[:-1]:
        sibs.append(gl.take(level, cur ^ 1, axis=0))
        cur = cur >> 1
    if not sibs:
        return torch.zeros((len(indices), 0, DIGEST_WIDTH), dtype=torch.int64,
                           device=device)
    return gl.stack(sibs, axis=1)


def verify_paths(leaf_digests: GF, indices, paths: GF, cap: GF,
                 n_leaves: int = None, cap_size: int = None) -> torch.Tensor:
    """Recompute roots from (q, 4) leaves + (q, depth, 4) sibling paths and
    compare with the cap. Returns a (q,) bool tensor.

    When `n_leaves`/`cap_size` are given (every verifier MUST pass them), the
    proof-supplied geometry is validated against them: path depth must be
    exactly log2(n_leaves / cap_size), the cap must have exactly cap_size
    entries, and indices must be in range — otherwise the proof would choose
    the tree depth and cap size."""
    idx_np = np.asarray(indices, dtype=np.uint64)
    device = leaf_digests.device
    if n_leaves is not None:
        assert cap_size is not None
        expected_depth = (n_leaves // cap_size).bit_length() - 1
        if (paths.shape[1] != expected_depth or cap.shape[0] != cap_size
                or leaf_digests.shape[0] != len(idx_np)
                or (len(idx_np) and int(idx_np.max()) >= n_leaves)):
            return torch.zeros((len(idx_np),), dtype=torch.bool, device=device)
    idx = torch.from_numpy(idx_np.astype(np.int64)).to(device)
    cur = leaf_digests
    depth = paths.shape[1]
    for d in range(depth):
        sib = paths[:, d, :]
        is_left = (((idx >> d) & 1) == 0)[:, None]
        left = gl.select(is_left, cur, sib)
        right = gl.select(is_left, sib, cur)
        cur = p2.hash_two_to_one(left, right)
    expected = gl.take(cap, idx >> depth, axis=0)
    return torch.all(gl.equal(cur, expected), dim=-1)
