"""Poseidon2 over the BN254 scalar field (t=3, rate 2, alpha=5).

The for-wrapper hasher and transcript of the reference: the final
compression circuit's FRI trees and transcript are hashed with a Bn256
Poseidon2 sponge so the BN254 PLONK WrapperCircuit can re-verify the proof
with native field gates (src/proof_wrapper_utils/mod.rs:30-31
`CircuitPoseidon2Sponge<Bn256, 2,3,3,true>` / `CircuitPoseidon2Transcript`;
consumed by prover_utils.rs:823-967 create/prove/verify_compression_for_
wrapper_*).

Shape: width t=3, rate 2, capacity 1, R_F=8 external rounds (4+4), R_P=56
internal rounds, x^5 S-box. External linear layer for t=3 is circ(2,1,1)
(y_i = x_i + sum); internal layer is all-ones + diag(mu).

Counterpart of the JAX package's `utils/poseidon2_bn254.py`. The round
constants and the diagonal are read from this package's own
`params/poseidon2_bn254.json`, a byte-identical copy of the JAX package's
table (pinned by tests/test_torch_bn254_hash.py); it is read, never
written, and a missing file raises. This module is the host side: exact
Python ints, the plain version of the card's kernel
(`ops/cuda_kernels.bn254_hash_rows` / `bn254_hash_pairs`) and the
transcript's sponge.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, Sequence

import numpy as np

from .bn254 import R as FR  # BN254 scalar field modulus

T = 3
RATE = 2
CAPACITY = 1
R_F = 8
R_P = 56
ALPHA = 5

GL_P = 0xFFFFFFFF_00000001  # Goldilocks: three canonical values pack one Fr
_M64 = (1 << 64) - 1

PARAMS_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "params", "poseidon2_bn254.json"))


@functools.lru_cache(maxsize=None)
def get_params_bn254() -> dict:
    with open(PARAMS_PATH) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def round_constants():
    """(external initial rounds, internal rounds, external final rounds,
    internal diagonal) as Python ints, from the table."""
    p = get_params_bn254()
    return (tuple(tuple(int(c) for c in rc) for rc in p["external_initial"]),
            tuple(int(c) for c in p["internal"]),
            tuple(tuple(int(c) for c in rc) for rc in p["external_final"]),
            tuple(int(d) for d in p["internal_diag"]))


def permute(state: Sequence[int]) -> List[int]:
    """One Poseidon2-BN254 permutation of a width-3 state: external layer,
    4 full rounds, 56 partial rounds, 4 full rounds."""
    ext0, internal, ext1, (d0, d1, d2) = round_constants()
    assert len(state) == T
    a, b, c = (int(v) % FR for v in state)
    t = a + b + c
    a, b, c = (a + t) % FR, (b + t) % FR, (c + t) % FR
    for c0, c1, c2 in ext0:
        a, b, c = pow(a + c0, 5, FR), pow(b + c1, 5, FR), pow(c + c2, 5, FR)
        t = a + b + c
        a, b, c = (a + t) % FR, (b + t) % FR, (c + t) % FR
    for ci in internal:
        a = pow(a + ci, 5, FR)
        t = a + b + c
        a, b, c = (t + d0 * a) % FR, (t + d1 * b) % FR, (t + d2 * c) % FR
    for c0, c1, c2 in ext1:
        a, b, c = pow(a + c0, 5, FR), pow(b + c1, 5, FR), pow(c + c2, 5, FR)
        t = a + b + c
        a, b, c = (a + t) % FR, (b + t) % FR, (c + t) % FR
    return [a, b, c]


def hash_elements(vals: Sequence[int]) -> int:
    """Sponge hash (overwrite mode, rate 2): Fr elements -> one Fr digest."""
    vals = [int(v) % FR for v in vals]
    vals += [0] * ((-len(vals)) % RATE)
    state = [0] * T
    for i in range(0, len(vals), RATE):
        state[:RATE] = vals[i:i + RATE]
        state = permute(state)
    return state[0]


def pack_goldilocks(row: Sequence[int]) -> List[int]:
    """Canonical Goldilocks values packed 3 per Fr (base-2^64 digits:
    v0 + v1*2^64 + v2*2^128 < 2^193 < R, injective). A value that is not
    canonical is refused: the card's kernel packs the bits as they are."""
    vals = [int(v) for v in row]
    assert all(0 <= v < GL_P for v in vals), \
        "Goldilocks values must be canonical (< p)"
    out = []
    for i in range(0, len(vals), 3):
        fr = 0
        for j, x in enumerate(vals[i:i + 3]):
            fr |= x << (64 * j)
        out.append(fr)
    return out


def to_limbs(values: Sequence[int]) -> np.ndarray:
    """Fr ints -> (k, 4) int64 little-endian 64-bit limbs (the bit
    patterns), the layout of the card's digests."""
    out = np.zeros((len(values), 4), dtype=np.uint64)
    for i, v in enumerate(values):
        v = int(v)
        for j in range(4):
            out[i, j] = (v >> (64 * j)) & _M64
    return out.view(np.int64)


def from_limbs(limbs) -> List[int]:
    """(k, 4) int64 limbs (numpy or a CPU tensor) -> Fr ints."""
    u = np.ascontiguousarray(np.asarray(limbs)).view(np.uint64).reshape(-1, 4)
    return [int(a) | (int(b) << 64) | (int(c) << 128) | (int(d) << 192)
            for a, b, c, d in u.tolist()]


class SpongeBn254:
    """Duplex sponge over the width-3 state (absorb rate-2 blocks,
    overwrite mode; squeeze from the rate lanes) — the for-wrapper
    transcript core (CircuitPoseidon2Transcript role)."""

    def __init__(self):
        self.state = [0] * T
        self.buffer: List[int] = []
        self.squeezed: List[int] = []
        self.read_since_permute = False

    def absorb(self, vals: Sequence[int]):
        self.squeezed = []
        self.read_since_permute = False
        self.buffer.extend(int(v) % FR for v in vals)
        while len(self.buffer) >= RATE:
            chunk, self.buffer = self.buffer[:RATE], self.buffer[RATE:]
            self.state[:RATE] = chunk
            self.state = permute(self.state)

    def _flush(self):
        if self.buffer:
            chunk = self.buffer + [0] * (RATE - len(self.buffer))
            self.buffer = []
            self.state[:RATE] = chunk
            self.state = permute(self.state)

    def squeeze(self) -> int:
        if not self.squeezed:
            self._flush()
            if self.read_since_permute:
                self.state = permute(self.state)
            self.squeezed = list(self.state[:RATE])
            self.read_since_permute = True
        return self.squeezed.pop(0)
