"""SNARK wrapper: the final BN254 PLONK proof over the compression chain.

Parity target: src/proof_wrapper_utils/wrapper.rs:108-275 — the reference
builds a bellman PLONK circuit that verifies the compression-for-wrapper
proof and exposes one BN254 Fr public input packing the scheduler's 4
Goldilocks public inputs.

Round-2 skeleton of that statement, over the real PLONK protocol
(utils/plonk.py): the wrapper circuit exposes [chunk_0..chunk_3, snark_pi]
and PROVES the packing relation

    snark_pi = ((chunk_0 * 2^56 + chunk_1) * 2^56 + chunk_2) * 2^56 + chunk_3

(the exact compress_stark_pi_to_snark_pi packing, prover/compression.py:57),
so an L1 verifier holding `snark_pi` is bound to the scheduler's Goldilocks
commitment chunks. In-SNARK verification of the compression STARK itself
(transcript replay + FRI checks as PLONK gates) is the remaining increment
and is tracked in docs/ARCHITECTURE.md.

Counterpart of the "pi" tier of the JAX package's `utils/snark_wrapper.py`,
moved across as it is. Its "binding" tier (an in-SNARK Poseidon2-BN254
digest of the for-wrapper VK, over `plonk_builder`) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..prover.compression import compress_stark_pi_to_snark_pi
from . import bn254 as bn
from . import plonk as pl

R = bn.R
_CHUNK_BITS = 56  # matches compression.compress_stark_pi_to_snark_pi
_SHIFT = 1 << _CHUNK_BITS
NUM_CHUNKS = 4


def build_wrapper_circuit() -> pl.PlonkCircuit:
    """8 gates: 5 public-input gates (4 chunks + packed value) and 3
    multiply-accumulate gates computing the Horner packing."""
    n = 8
    qL = [0] * n
    qR = [0] * n
    qO = [0] * n
    qM = [0] * n
    qC = [0] * n
    # copy classes: c0..c3 -> 0..3, packed -> 4, t1 -> 5, t2 -> 6; unused -> -k
    wa = [0, 1, 2, 3, 4, 0, 5, 6]
    wb = [-1, -2, -3, -4, -5, 1, 2, 3]
    wc = [-6, -7, -8, -9, -10, 5, 6, 4]
    for g in range(5):            # public gates: a - x = 0
        qL[g] = 1
    for g in range(5, 8):         # t = SHIFT*a + b  =>  SHIFT*a + b - t = 0
        qL[g] = _SHIFT % R
        qR[g] = 1
        qO[g] = (-1) % R
    return pl.PlonkCircuit(num_gates=n, qL=qL, qR=qR, qO=qO, qM=qM, qC=qC,
                           wires=(wa, wb, wc), public_gates=[0, 1, 2, 3, 4])


def wrapper_setup(crs: Optional[List] = None,
                  g2_powers: Optional[Tuple] = None) -> pl.PlonkSetup:
    return pl.plonk_setup(build_wrapper_circuit(), crs, g2_powers)


def wrap_scheduler_pi(setup: pl.PlonkSetup,
                      scheduler_pi: Sequence[int]) -> pl.PlonkProof:
    """Produce the wrapper proof for a scheduler/compression public-input
    vector (4 Goldilocks values)."""
    assert len(scheduler_pi) == NUM_CHUNKS
    c = [int(v) % R for v in scheduler_pi]
    t1 = (c[0] * _SHIFT + c[1]) % R
    t2 = (t1 * _SHIFT + c[2]) % R
    packed = (t2 * _SHIFT + c[3]) % R
    wa = [c[0], c[1], c[2], c[3], packed, c[0], t1, t2]
    wb = [0, 0, 0, 0, 0, c[1], c[2], c[3]]
    wc = [0, 0, 0, 0, 0, t1, t2, packed]
    return pl.plonk_prove(setup, (wa, wb, wc), [c[0], c[1], c[2], c[3],
                                                packed])


def verify_wrapped_proof(vk: pl.PlonkVerificationKey, proof: pl.PlonkProof,
                         expected_scheduler_pi: Optional[Sequence[int]] = None
                         ) -> bool:
    """PLONK-verify + (optionally) pin the exposed chunks to the expected
    scheduler public inputs and recheck the packed value."""
    if len(proof.public_inputs) != NUM_CHUNKS + 1:
        return False
    chunks = [int(v) % R for v in proof.public_inputs[:NUM_CHUNKS]]
    packed = int(proof.public_inputs[NUM_CHUNKS]) % R
    if packed != compress_stark_pi_to_snark_pi(chunks):
        return False
    if expected_scheduler_pi is not None:
        if chunks != [int(v) % R for v in expected_scheduler_pi]:
            return False
    return pl.plonk_verify(vk, proof)
