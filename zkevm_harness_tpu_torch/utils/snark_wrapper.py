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

Counterpart of the JAX package's `utils/snark_wrapper.py`, moved across as
it is: the "pi" tier and the "binding" tier (an in-SNARK Poseidon2-BN254
digest of the for-wrapper VK, over `plonk_builder`). The "full" tier is
`utils/snark_fri_verifier.py`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..prover.compression import compress_stark_pi_to_snark_pi
from . import bn254 as bn
from . import plonk as pl
from . import plonk_builder as pb
from . import poseidon2_bn254 as p2b

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


# ---------------------------------------------------------------------------
# Binding wrapper: native Poseidon2-BN254 gates over the for-wrapper VK
# ---------------------------------------------------------------------------
#
# One step beyond the packing relation toward the reference WrapperCircuit
# (wrapper.rs:108-275): the circuit HASHES, with in-SNARK Poseidon2-BN254
# gates (the exact sponge the for-wrapper proof's trees/transcript use),
# the for-wrapper VK together with the scheduler PI chunks, and exposes
# binding = P2_bn254(fw_vk[0..4] || chunks[0..4])
# alongside the packed L1 public input. An L1 verifier holding (packed,
# binding) is thus bound to a SPECIFIC for-wrapper verification key through
# a native-field hash proven in-circuit; full in-SNARK FRI verification is
# the "full" tier (utils/snark_fri_verifier.py).

def build_binding_wrapper_circuit(vk_len: int = 4):
    """PLONK circuit: PIs = [vk..., chunk0..3, packed, binding]; proves
    the 56-bit Horner packing AND binding = P2bn254(vk || chunks), about
    565 gates per Poseidon2 permutation."""
    b = pb.PlonkBuilder()
    vk = b.inputs(vk_len)
    chunks = b.inputs(NUM_CHUNKS)
    t1 = b.lin(_SHIFT, chunks[0], 1, chunks[1])
    t2 = b.lin(_SHIFT, t1, 1, chunks[2])
    packed = b.lin(_SHIFT, t2, 1, chunks[3])
    binding = b.hash_elements(vk + chunks)
    for v in vk + chunks + [packed, binding]:
        b.mark_public(v)
    return b, dict(vk=vk, chunks=chunks, packed=packed, binding=binding)


def wrap_with_binding(fw_vk: Sequence[int], scheduler_pi: Sequence[int],
                      crs=None, g2_powers=None):
    """Prove the binding wrapper for a for-wrapper VK (Fr cap digests)
    and the 4 scheduler PI chunks. Returns (setup, proof)."""
    b, lay = build_binding_wrapper_circuit(vk_len=len(list(fw_vk)))
    circ = b.finalize()
    setup = pl.plonk_setup(circ, crs, g2_powers)
    asg = {v: int(x) % R for v, x in zip(lay["vk"], fw_vk)}
    asg.update({v: int(x) % R for v, x in
                zip(lay["chunks"], scheduler_pi)})
    wires, pis = b.fill(asg)
    proof = pl.plonk_prove(setup, wires, pis)
    return setup, proof


def verify_binding_proof(vk: pl.PlonkVerificationKey, proof: pl.PlonkProof,
                         expected_fw_vk: Optional[Sequence[int]] = None,
                         expected_scheduler_pi: Optional[Sequence[int]] = None
                         ) -> bool:
    """PLONK-verify + recheck the exposed packing and binding digest."""
    k = len(proof.public_inputs) - NUM_CHUNKS - 2
    if k < 1:
        return False
    if expected_fw_vk is not None and k != len(list(expected_fw_vk)):
        return False
    fw_vk = [int(v) % R for v in proof.public_inputs[:k]]
    chunks = [int(v) % R for v in proof.public_inputs[k:k + NUM_CHUNKS]]
    packed = int(proof.public_inputs[k + NUM_CHUNKS]) % R
    binding = int(proof.public_inputs[k + NUM_CHUNKS + 1]) % R
    if packed != compress_stark_pi_to_snark_pi(chunks):
        return False
    if binding != p2b.hash_elements(fw_vk + chunks):
        return False
    if expected_fw_vk is not None and \
            fw_vk != [int(v) % R for v in expected_fw_vk]:
        return False
    if expected_scheduler_pi is not None and \
            chunks != [int(v) % R for v in expected_scheduler_pi]:
        return False
    return pl.plonk_verify(vk, proof)


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
