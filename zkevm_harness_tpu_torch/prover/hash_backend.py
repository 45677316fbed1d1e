"""Pluggable proof-hash backends: Merkle tree hasher + Fiat-Shamir transcript.

The reference's prover is generic over (H, TR) — Goldilocks Poseidon2 for
every layer except compression-FOR-WRAPPER, which switches to a Bn256
Poseidon2 sponge/transcript so the BN254 PLONK WrapperCircuit can verify
the FRI proof with native-field gates (src/prover_utils.rs:36-44 vs
:900-967; src/proof_wrapper_utils/mod.rs:30-31). Here the same switch is a
backend object threaded through plonkish.prove/verify and fri: the default
(None) keeps the Goldilocks Poseidon2 path; `Bn254Backend` hashes trees
over BN254 Fr and runs the transcript over the width-3 BN254 sponge.

Encoding: a Merkle leaf is the sponge hash of its row, packed 3 canonical
Goldilocks values per Fr; a node is hash(left, right) (one rate-2 block =
one permutation). Query paths carry one Fr per level. Transcript absorbs
take each Goldilocks element as one Fr.

Counterpart of the JAX package's `prover/hash_backend.py`. The trees are
built where the LDE lies: `commit_rows` and `hash_rows` take the port's
column-major (w, k) tensor, and every level stays on its device as (m, 4)
int64 limbs (`ops/cuda_kernels.bn254_hash_rows` / `bn254_hash_pairs`, the
card's kernel; their plain versions on the CPU). Only the cap and the
opened paths become Python ints. The transcript stays host Python, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops import goldilocks as gl
from ..utils import poseidon2_bn254 as p2b
from ..utils.bn254 import R as FR

P = gl.P


@dataclasses.dataclass
class Bn254Tree:
    levels: List[torch.Tensor]  # levels[0] = leaf digests ... [-1] = cap
    cap_size: int

    @property
    def cap(self) -> List[int]:
        return p2b.from_limbs(self.levels[-1].cpu())

    @property
    def depth(self) -> int:
        return len(self.levels) - 1


class Bn254Transcript:
    """Same method surface as prover/transcript.Transcript, over the
    width-3 BN254 sponge. Goldilocks values absorb as one Fr each;
    challenges come from Fr squeezes split into two 64-bit halves reduced
    into Goldilocks (CircuitPoseidon2Transcript role). Host Python ints;
    `device` is where `challenge_ext` puts its scalars."""

    def __init__(self, domain_tag: int = 0, device=None):
        self.device = gl.resolve_device(device)
        self._sp = p2b.SpongeBn254()
        if domain_tag:
            self._sp.state[p2b.T - 1] = domain_tag % FR

    # -- absorbing --------------------------------------------------------

    def absorb_ints(self, values: Sequence[int]):
        self._sp.absorb([int(v) % P for v in values])

    def absorb_gf(self, values: gl.GF):
        self.absorb_ints([int(v) for v in gl.to_u64(values).ravel()])

    absorb_gf_device = absorb_gf

    def absorb_fr(self, values: Sequence[int]):
        self._sp.absorb([int(v) % FR for v in values])

    # -- squeezing ---------------------------------------------------------

    def challenge_base(self) -> int:
        return (self._sp.squeeze() % (1 << 64)) % P

    def challenge_ext_ints(self):
        fr = self._sp.squeeze()
        return ((fr % (1 << 64)) % P, ((fr >> 64) % (1 << 64)) % P)

    def challenge_ext(self) -> gl.GF2:
        c0, c1 = self.challenge_ext_ints()
        return gl.ext_from_ints(c0, c1, self.device)

    def query_indices(self, count: int, domain: int) -> List[int]:
        return [self._sp.squeeze() % domain for _ in range(count)]


class Bn254Backend:
    """Tree hasher + transcript factory for the for-wrapper mode. `device`
    is where the verifier hashes opened rows and walks paths (`None`: the
    CUDA card, raising where there is none)."""

    name = "bn254_poseidon2"

    def __init__(self, device=None):
        self.device = gl.resolve_device(device)

    def transcript(self, domain_tag: int = 0) -> Bn254Transcript:
        return Bn254Transcript(domain_tag, self.device)

    # -- trees --------------------------------------------------------------

    @staticmethod
    def pack_row(row) -> List[int]:
        """Pack canonical Goldilocks values 3-per-Fr (base-2^64 digits:
        v0 + v1*2^64 + v2*2^128 < 2^193 < R, injective)."""
        return p2b.pack_goldilocks(row)

    @staticmethod
    def hash_rows(cols: torch.Tensor) -> torch.Tensor:
        """cols: (w, k) canonical Goldilocks tensor -> (k, 4) Fr limbs, on
        the tensor's device."""
        return ck.bn254_hash_rows(cols)

    def commit_rows(self, cols: torch.Tensor, cap_size: int) -> Bn254Tree:
        """A tree over the k rows of `cols` (w, k); its levels stay on the
        tensor's device."""
        levels = [self.hash_rows(cols)]
        cap_size = min(cap_size, levels[0].shape[0])
        while levels[-1].shape[0] > cap_size:
            levels.append(ck.bn254_hash_pairs(levels[-1]))
        return Bn254Tree(levels=levels, cap_size=cap_size)

    @staticmethod
    def open(tree: Bn254Tree, indices: Sequence[int]) -> np.ndarray:
        """(q, depth) object array: sibling digests bottom-up."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
        out = np.zeros((len(idx), tree.depth), dtype=object)
        for d in range(tree.depth):
            level = tree.levels[d]
            sib = level[(idx ^ 1).to(level.device)].cpu()
            out[:, d] = p2b.from_limbs(sib)
            idx = idx >> 1
        return out

    def verify_paths(self, leaf_digests: torch.Tensor,
                     indices: Sequence[int], paths: np.ndarray,
                     cap: Sequence[int]) -> bool:
        """Walk every path to the cap, one level of all paths at a time
        (one `bn254_hash_pairs` each) on the backend's device.
        `leaf_digests` is the (q, 4) limb tensor of `hash_rows`."""
        q = len(indices)
        if q == 0:
            return True
        paths = np.asarray(paths, dtype=object)
        depth = paths.shape[1] if paths.size else 0
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.device)
        cur = leaf_digests.to(self.device)
        for d in range(depth):
            sib = torch.from_numpy(p2b.to_limbs(
                [int(v) % FR for v in paths[:, d]])).to(self.device)
            right = ((idx & 1) == 1).unsqueeze(-1)
            left_half = torch.where(right, sib, cur)
            right_half = torch.where(right, cur, sib)
            cur = ck.bn254_hash_pairs(
                torch.stack([left_half, right_half], dim=1).reshape(-1, 4))
            idx = idx >> 1
        got = p2b.from_limbs(cur.cpu())
        cap = [int(v) for v in cap]
        return all(0 <= int(i) < len(cap) and g == cap[int(i)]
                   for g, i in zip(got, idx.cpu().tolist()))
