"""Compression chain + SNARK-wrapper orchestration (data-flow layer).

Parity with src/proof_wrapper_utils/ (SURVEY L6, components 14-15):
  - `WrapperConfig` with 1..=5 compression layers (mod.rs:66-95) and the
    `COMPRESSION_NUM` env override used by the testing config;
  - `compute_compression_circuits`: for each mode, guarded by the data source
    (resume), prove-with-pluggable-prover then VERIFY-AFTER-PROVE
    (compression.rs:87-140 discipline);
  - previous-proof/VK chaining (mode 1 consumes the scheduler proof —
    utils.rs:52-74);
  - `compress_stark_pi_to_snark_pi`: pack the 4 Goldilocks scheduler public
    inputs into one BN254 Fr as 56-bit chunks, high PI first (utils.rs:24-49).

The per-mode compression circuits are real in-circuit verifiers of the
previous layer's FRI proof (prover/layers.py CompressionChain, built on
circuits/verifier_circuit.py); `prove_fn`/`verify_fn` stay injectable so the
orchestration can also run under satisfiability-only model provers, the same
way the reference tests use DevCSConfig runs before real proving.

Counterpart of the JAX package's `prover/compression.py`, moved across as it
is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

from ..utils.data_source import InMemoryDataSource

BN254_FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
NUM_SCHEDULER_PUBLIC_INPUTS = 4
_CHUNK_BITS = 56  # (GoldilocksField::CAPACITY_BITS / 8) * 8


@dataclasses.dataclass(frozen=True)
class WrapperConfig:
    compression_layers: int = 1

    def __post_init__(self):
        assert 1 <= self.compression_layers <= 5

    def get_compression_types(self) -> List[int]:
        """Plain compression modes 1..k-1 (mod.rs:78-86)."""
        return list(range(1, self.compression_layers))

    def get_final_compression_type(self) -> int:
        """The for-wrapper mode k (mod.rs:88-92)."""
        return self.compression_layers


def get_testing_wrapper_config() -> WrapperConfig:
    """COMPRESSION_NUM env override (testing_wrapper.rs)."""
    k = int(os.environ.get("COMPRESSION_NUM", "1"))
    return WrapperConfig(compression_layers=k)


def compress_stark_pi_to_snark_pi(stark_pi) -> int:
    assert len(stark_pi) == NUM_SCHEDULER_PUBLIC_INPUTS
    assert NUM_SCHEDULER_PUBLIC_INPUTS * _CHUNK_BITS <= 253
    result = 0
    coeff = 1
    for chunk in reversed(list(stark_pi)):
        result = (result + int(chunk) * coeff) % BN254_FR
        coeff = (coeff << _CHUNK_BITS) % BN254_FR
    return result


def get_proof_for_previous_circuit(source, circuit_type: int):
    if circuit_type == 1:
        prev = source.get_scheduler_proof()
        # the DAG's scheduler task stores a RECORD dict; unwrap it
        if isinstance(prev, dict) and "proof" in prev:
            prev = prev["proof"]
        return prev
    return source.get_compression_proof(circuit_type - 1)


def compute_compression_circuits(
        source, config: WrapperConfig,
        prove_fn: Callable[[int, object], Tuple[object, object]],
        verify_fn: Callable[[int, object, object], bool]):
    """Sequential compression modes 1..k-1 with resume + verify-after-prove.

    prove_fn(mode, previous_proof) -> (proof, vk);
    verify_fn(mode, proof, vk) -> bool.
    """
    for mode in config.get_compression_types():
        if source.get_compression_proof(mode) is not None:
            continue
        prev = get_proof_for_previous_circuit(source, mode)
        assert prev is not None, f"missing input proof for mode {mode}"
        proof, vk = prove_fn(mode, prev)
        assert verify_fn(mode, proof, vk), \
            f"compression mode {mode} proof failed verification"
        source.set_compression_vk(vk, mode)
        source.set_compression_proof(proof, mode)


def wrap_proof(scheduler_proof, scheduler_pi, config: WrapperConfig,
               prove_fn, verify_fn,
               source: Optional[InMemoryDataSource] = None):
    """Full wrapping flow skeleton (mod.rs:99-154): compression chain, then
    the final for-wrapper mode, then the SNARK wrapper public input."""
    source = source or InMemoryDataSource()
    if source.get_scheduler_proof() is None:  # the DAG may own the record
        source.set_scheduler_proof(scheduler_proof)
    compute_compression_circuits(source, config, prove_fn, verify_fn)
    final_mode = config.get_final_compression_type()
    prev = get_proof_for_previous_circuit(source, final_mode)
    proof, vk = prove_fn(final_mode, prev)
    assert verify_fn(final_mode, proof, vk)
    source.set_compression_proof(proof, final_mode)
    snark_pi = compress_stark_pi_to_snark_pi(scheduler_pi)
    return {"final_proof": proof, "final_vk": vk,
            "snark_public_input": snark_pi}
