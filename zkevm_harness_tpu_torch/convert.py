"""State carried between the JAX package and this port, as numpy arrays.

The JAX package stores a field element as a (lo, hi) pair of uint32 planes;
the port stores one int64 holding the u64 bit pattern. This module converts
field arrays, a `PlonkishSetup` and a `PlonkishProof` in both directions. It
imports neither `jax` nor the JAX package: the caller hands over numpy arrays
(`np.asarray(gf.lo)`, `np.asarray(gf.hi)`) and gets numpy arrays back, so the
tests can run both packages on the same data.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .ops import goldilocks as gl
from .ops import merkle as mk
from .prover import plonkish as pk
from .utils import serde

Pairs = Tuple[np.ndarray, np.ndarray]  # (lo, hi) uint32 planes


# -- field arrays -----------------------------------------------------------

def pairs_to_u64(lo, hi) -> np.ndarray:
    """(lo, hi) uint32 planes -> uint64 values hi * 2^32 + lo."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


def u64_to_pairs(u) -> Pairs:
    """uint64 values -> (lo, hi) uint32 planes."""
    u = np.asarray(u, dtype=np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def tensor_from_pairs(lo, hi, device=None) -> torch.Tensor:
    """(lo, hi) uint32 planes -> the port's int64 field tensor."""
    return gl.from_u64(pairs_to_u64(lo, hi), device)


def pairs_from_tensor(t: torch.Tensor) -> Pairs:
    """The port's int64 field tensor -> (lo, hi) uint32 planes."""
    return u64_to_pairs(gl.to_u64(t))


# -- setup ------------------------------------------------------------------

def setup_to_numpy(setup: pk.PlonkishSetup) -> Dict:
    """A port `PlonkishSetup` as plain numpy: (lo, hi) planes for the column
    blocks and every tree level, the padded tables and the cap as they are."""
    return {
        "const_cols": pairs_from_tensor(setup.const_cols),
        "sigma_cols": pairs_from_tensor(setup.sigma_cols),
        "table_cols": pairs_from_tensor(setup.table_cols),
        "table_np": tuple(setup.table_np),
        "tree_levels": [pairs_from_tensor(lv) for lv in setup.tree.levels],
        "cap_np": setup.cap_np,
    }


def setup_from_numpy(const_cols: Pairs, sigma_cols: Pairs, table_cols: Pairs,
                     table_np: Sequence[np.ndarray],
                     tree_levels: Sequence[Pairs],
                     device=None) -> pk.PlonkishSetup:
    """A port `PlonkishSetup` from the numpy arrays of a JAX `PlonkishSetup`
    (`np.asarray` of each `.lo`/`.hi`; `tree_levels` from `setup.tree.levels`).
    Nothing is recomputed: the tree is taken as given."""
    levels = tuple(tensor_from_pairs(lo, hi, device) for lo, hi in tree_levels)
    tree = mk.MerkleTree(levels)
    return pk.PlonkishSetup(
        const_cols=tensor_from_pairs(*const_cols, device),
        sigma_cols=tensor_from_pairs(*sigma_cols, device),
        table_cols=tensor_from_pairs(*table_cols, device),
        table_np=tuple(np.asarray(t, dtype=object) for t in table_np),
        tree=tree, cap_np=gl.to_ints(tree.cap))


# -- proofs -----------------------------------------------------------------

def proof_to_json(proof):
    """A `PlonkishProof` of either package -> the shared JSON structure."""
    return serde.proof_to_json(proof)


def proof_from_json(data, registry=None):
    """The shared JSON structure -> a proof. `registry` maps dataclass names
    to classes: the port's by default, the JAX package's
    `serde.default_registry()` to get a JAX proof."""
    return serde.proof_from_json(
        data, serde.default_registry() if registry is None else registry)


def proof_to_package(proof, registry=None):
    """Re-type a proof of one package as the other's, through the JSON."""
    return proof_from_json(proof_to_json(proof), registry)
