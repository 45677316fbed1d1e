"""Batched Poseidon2 permutation + sponge over Goldilocks (PyTorch).

Counterpart of the JAX package's `ops/poseidon2.py`. The state is a field
tensor of shape (..., 12); the permutation runs over any leading batch dims.
On a CUDA tensor `permute` launches the hand-written kernel
(`cuda_kernels.poseidon2_permute`); on a CPU tensor it runs the plain
version. The sponge is a Python loop over rate-8 chunks, each one
permutation of the whole batch.
"""

from __future__ import annotations

import torch

from . import cuda_kernels as ck
from .goldilocks import GF
from .poseidon2_params import CAPACITY, RATE, T

permute = ck.poseidon2_permute


def _overwrite(state: GF, values: GF, offset: int) -> GF:
    """state with lanes [offset, offset + k) replaced by values (..., k)."""
    k = values.shape[-1]
    return torch.cat([state[..., :offset], values,
                      state[..., offset + k:]], dim=-1)


def hash_two_to_one(left: GF, right: GF) -> GF:
    """Node hash: absorb [left(4) || right(4)] into the rate, one permutation.

    left/right: (..., 4) digests. Returns (..., 4)."""
    cap = torch.zeros(left.shape[:-1] + (T - RATE,), dtype=torch.int64,
                      device=left.device)
    state = permute(torch.cat([left, right, cap], dim=-1))
    return state[..., :CAPACITY]


def hash_elements(elems: GF) -> GF:
    """Variable-length hash of (..., n) field elements -> (..., 4) digest.

    Overwrite-mode absorption in rate-8 chunks, zero padding; the digest is
    lanes 0..3 of the final state."""
    return absorb_elements(None, elems)[..., :CAPACITY]


def absorb_elements(state, elems: GF) -> GF:
    """The sponge of `hash_elements` carried on: (..., n) elements absorbed
    in rate-8 chunks into `state` (None: the zero state), the last chunk
    zero-padded; returns the state. Elements given in pieces of whole
    chunks, each absorbed into the state the one before left, hash as if
    given at once."""
    batch = elems.shape[:-1]
    n = elems.shape[-1]
    if state is None:
        state = torch.zeros(batch + (T,), dtype=torch.int64,
                            device=elems.device)
    for start in range(0, n, RATE):
        chunk = elems[..., start:start + RATE]
        short = RATE - chunk.shape[-1]
        if short:  # zero-pad the last chunk only
            chunk = torch.cat([chunk, torch.zeros(
                batch + (short,), dtype=torch.int64, device=elems.device)],
                dim=-1)
        state = permute(_overwrite(state, chunk, 0))
    return state


def full_width_absorb(state: GF, encoding: GF) -> GF:
    """Full-width queue step: overwrite the rate lanes with the encoding and
    permute. state: (..., 12); encoding: (..., 8) -> new state (..., 12)."""
    return permute(_overwrite(state, encoding, 0))


def absorb_chunks(state: GF, chunks: GF) -> GF:
    """Serial overwrite-absorb of (k, RATE) chunks into one (12,) state."""
    for i in range(chunks.shape[0]):
        state = permute(_overwrite(state, chunks[i], 0))
    return state
