"""Circuit type registry: numbering, layers, proof configs, global constants.

Ground-truth parity with the reference (SURVEY §2c):
  - base layer numbering from circuit_definitions base_layer/mod.rs:215-239
    (confirmed by setup/base_layer/vk_{1..13}.json iteration at
    src/tests/complex_tests/mod.rs:430-433)
  - recursion layer numbering from recursion_layer/mod.rs:56-76
  - compression modes from aux_layer/mod.rs:41-48
  - global constants from circuit_definitions/src/lib.rs:12-57 and
    recursion_layer/mod.rs:25-29.
"""

from __future__ import annotations

import dataclasses
import enum


class BaseLayerCircuitType(enum.IntEnum):
    MAIN_VM = 1
    CODE_DECOMMITTMENTS_SORTER = 2
    CODE_DECOMMITTER = 3
    LOG_DEMUXER = 4
    KECCAK_ROUND_FUNCTION = 5
    SHA256_ROUND_FUNCTION = 6
    ECRECOVER = 7
    RAM_PERMUTATION = 8
    STORAGE_SORTER = 9
    STORAGE_APPLICATION = 10
    EVENTS_SORTER = 11
    L1_MESSAGES_SORTER = 12
    L1_MESSAGES_HASHER = 13


class RecursionLayerCircuitType(enum.IntEnum):
    SCHEDULER = 1
    NODE = 2
    # 3..15: one leaf type per base circuit type (leaf_for(base) below)
    LEAF_MAIN_VM = 3
    LEAF_CODE_DECOMMITTMENTS_SORTER = 4
    LEAF_CODE_DECOMMITTER = 5
    LEAF_LOG_DEMUXER = 6
    LEAF_KECCAK = 7
    LEAF_SHA256 = 8
    LEAF_ECRECOVER = 9
    LEAF_RAM_PERMUTATION = 10
    LEAF_STORAGE_SORTER = 11
    LEAF_STORAGE_APPLICATION = 12
    LEAF_EVENTS_SORTER = 13
    LEAF_L1_MESSAGES_SORTER = 14
    LEAF_L1_MESSAGES_HASHER = 15


def leaf_for(base: BaseLayerCircuitType) -> RecursionLayerCircuitType:
    return RecursionLayerCircuitType(int(base) + 2)


def base_for_leaf(leaf: RecursionLayerCircuitType) -> BaseLayerCircuitType:
    assert int(leaf) >= 3
    return BaseLayerCircuitType(int(leaf) - 2)


class CompressionMode(enum.IntEnum):
    MODE_1 = 1
    MODE_2 = 2
    MODE_3 = 3
    MODE_4 = 4
    MODE_5 = 5


# Global constants (circuit_definitions/src/lib.rs:12-57, recursion_layer/mod.rs)
TARGET_CIRCUIT_TRACE_LENGTH = 1 << 20
RECURSION_ARITY = 32
SCHEDULER_CAPACITY = 24_100
L1_SECURITY_BITS = 80
EIP4844_CYCLE_LIMIT = 4096
L1_VERIFIER_DOMAIN_SIZE_LOG = 24  # SNARK wrapper Bn254 domain


@dataclasses.dataclass(frozen=True)
class ProofSystemConfig:
    """FRI proof config per layer (ProofConfig in the reference)."""

    lde_factor: int
    merkle_cap_size: int
    security_bits: int
    pow_bits: int = 0


BASE_LAYER_PROOF_CONFIG = ProofSystemConfig(2, 16, 100)
RECURSION_LAYER_PROOF_CONFIG = ProofSystemConfig(2, 16, 100)
EIP4844_PROOF_CONFIG = ProofSystemConfig(2, 16, 100)

# compression_modes/mode_{1..5}.rs:99-110
COMPRESSION_PROOF_CONFIGS = {
    CompressionMode.MODE_1: ProofSystemConfig(32, 16, 80),
    CompressionMode.MODE_2: ProofSystemConfig(512, 16, 80),
    CompressionMode.MODE_3: ProofSystemConfig(1024, 16, 80),
    CompressionMode.MODE_4: ProofSystemConfig(2048, 256, 80),
    CompressionMode.MODE_5: ProofSystemConfig(4096, 8, 80),
}
COMPRESSION_FOR_WRAPPER_PROOF_CONFIGS = {
    CompressionMode.MODE_1: ProofSystemConfig(2, 16, 80),
    CompressionMode.MODE_2: ProofSystemConfig(512, 16, 80),
    CompressionMode.MODE_3: ProofSystemConfig(1024, 16, 80),
    CompressionMode.MODE_4: ProofSystemConfig(2048, 256, 80),
    CompressionMode.MODE_5: ProofSystemConfig(4096, 8, 80),
}


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Cycles-per-circuit-instance capacities at 2^20 rows.

    Values are the committed generator output
    (circuit_sequencer_api/src/geometry_config.rs:5-19); regenerate with
    tools/capacity_estimator once gate evaluators land.
    """

    cycles_per_vm_snapshot: int = 5585
    cycles_per_code_decommitter_sorter: int = 117_500
    cycles_per_log_demuxer: int = 58_750
    cycles_per_storage_sorter: int = 46_921
    cycles_per_events_or_l1_messages_sorter: int = 31_287
    cycles_per_ram_permutation: int = 136_714
    cycles_per_code_decommitter: int = 2845
    cycles_per_storage_application: int = 33
    cycles_per_keccak256_circuit: int = 293
    cycles_per_sha256_circuit: int = 2206
    cycles_per_ecrecover_circuit: int = 7
    limit_for_l1_messages_pudata_hasher: int = 774
    # state-tree depth for the type-10 circuit (production 256; the
    # testing-geometry analogue reduces it so CPU tests can PROVE paths —
    # the hashing rules are depth-uniform, witness/tree.py)
    storage_tree_depth: int = 256


# the GeometryConfig field that caps one instance of each base type
_BASE_CAPACITY_FIELD = {
    BaseLayerCircuitType.MAIN_VM: "cycles_per_vm_snapshot",
    BaseLayerCircuitType.CODE_DECOMMITTMENTS_SORTER:
        "cycles_per_code_decommitter_sorter",
    BaseLayerCircuitType.CODE_DECOMMITTER: "cycles_per_code_decommitter",
    BaseLayerCircuitType.LOG_DEMUXER: "cycles_per_log_demuxer",
    BaseLayerCircuitType.KECCAK_ROUND_FUNCTION: "cycles_per_keccak256_circuit",
    BaseLayerCircuitType.SHA256_ROUND_FUNCTION: "cycles_per_sha256_circuit",
    BaseLayerCircuitType.ECRECOVER: "cycles_per_ecrecover_circuit",
    BaseLayerCircuitType.RAM_PERMUTATION: "cycles_per_ram_permutation",
    BaseLayerCircuitType.STORAGE_SORTER: "cycles_per_storage_sorter",
    BaseLayerCircuitType.STORAGE_APPLICATION:
        "cycles_per_storage_application",
    BaseLayerCircuitType.EVENTS_SORTER:
        "cycles_per_events_or_l1_messages_sorter",
    BaseLayerCircuitType.L1_MESSAGES_SORTER:
        "cycles_per_events_or_l1_messages_sorter",
    BaseLayerCircuitType.L1_MESSAGES_HASHER:
        "limit_for_l1_messages_pudata_hasher",
}


def base_capacity(geometry: GeometryConfig, ctype: int) -> int:
    """The per-instance capacity of base type `ctype` at `geometry`."""
    return getattr(geometry, _BASE_CAPACITY_FIELD[ctype])


def testing_geometry() -> GeometryConfig:
    """Tiny capacities for fast tests (cf. run_manually.rs:184-200)."""
    return GeometryConfig(
        cycles_per_vm_snapshot=5,
        cycles_per_code_decommitter_sorter=16,
        cycles_per_log_demuxer=8,
        cycles_per_storage_sorter=4,
        cycles_per_events_or_l1_messages_sorter=2,
        cycles_per_ram_permutation=4,
        cycles_per_code_decommitter=4,
        cycles_per_storage_application=2,
        cycles_per_keccak256_circuit=1,
        cycles_per_sha256_circuit=1,
        cycles_per_ecrecover_circuit=1,
        limit_for_l1_messages_pudata_hasher=2,
    )
