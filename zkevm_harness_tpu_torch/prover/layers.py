"""Typed per-layer prover surface: setup/prove/verify per circuit type.

Counterpart of the JAX package's `prover/layers.py`, in part: for each of
the 13 base circuit types a `*_setup_data`, a prove and a verify function
(`prove_*_instance`, type 7 `prove_ecrecover_invocation`, type 10
`prove_storage_application_path` and its read + write `*_query` pair), with
what they need (`SetupData`, the setup cache, the engine config and its
override); the base layer's typed surface (`CircuitFactory`,
`BASE_REGISTRY` — empty, as in the JAX package, since every base type has
its real circuit — `create_base_layer_setup_data`,
`prove_base_layer_circuit`, `verify_base_layer_proof`,
`REAL_BASE_CIRCUITS`, `real_base_instance_public_inputs`,
`base_setup_for_type`); and `prove_base_instance` / `verify_base_instance`,
the JAX package's `harness.py` dispatch over the payloads
`witness.oracle.block_payloads` gives. These five read one per-type table,
`BASE_CIRCUITS`. The recursion layer's typed surface:
`RECURSION_REGISTRY` (the JAX package's stand-ins),
`create_recursive_layer_setup_data`, `prove_recursion_layer_circuit`,
`verify_recursion_layer_proof`, and the leaf queue-segment proofs
(`prove_leaf_queue_segment`, `verify_leaf_queue_segment`). The blob branch
(`create_eip4844_setup_data`, `prove_eip4844`, `verify_eip4844`) and the
compression layers (`CompressionSetup`, `compression_engine_config`,
`create_compression_layer_setup_data`, `prove_compression_layer_circuit`,
`verify_compression_layer_proof`, `CompressionChain`), Goldilocks-hashed
only: the BN254-hashed compression for the wrapper is not ported yet.

`prove_*_instance` builds the witness inside a `layers.witness` span of
utils/tracing.py (the witness fill time of a traced run) and checks the
proof's public inputs against the instance's before it returns; a
`verify_*_instance` compares them first and returns False on a mismatch.

Layer proof configs come from circuits/types.py (base layer: lde 2, cap 16,
security 100 bits -> 50 queries). Setup data is cached per geometry, engine
config and device, as the reference reuses setup per circuit type across
instances.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

from ..circuits import decommitter_circuit as cdcirc
from ..circuits import decommitts_sorter_circuit as dscirc
from ..circuits import ecrecover_circuit as eccirc
from ..circuits import eip4844_circuit as e4
from ..circuits import events_sorter_circuit as ecirc
from ..circuits import ffarith as ffmod
from ..circuits import keccak_circuit as kcirc
from ..circuits import linear_hasher_circuit as lhcirc
from ..circuits import log_demux_circuit as dcirc
from ..circuits import main_vm_circuit as mvcirc
from ..circuits import narrow_region as nrr_mod
from ..circuits import poseidon2_circuit as p2circ
from ..circuits import queue_circuit as qcirc
from ..circuits import ram_permutation_circuit as rcirc
from ..circuits import sha256_circuit as shcirc
from ..circuits import storage_application_circuit as sappcirc
from ..circuits import storage_sorter_circuit as sscirc
from ..circuits import verifier_circuit as vc
from ..circuits.types import (BASE_LAYER_PROOF_CONFIG,
                              COMPRESSION_FOR_WRAPPER_PROOF_CONFIGS,
                              COMPRESSION_PROOF_CONFIGS,
                              RECURSION_LAYER_PROOF_CONFIG,
                              BaseLayerCircuitType, CompressionMode,
                              ProofSystemConfig, base_capacity)
from ..ops import goldilocks as gl
from ..ops import ntt as nt
from ..utils import tracing
from . import hash_backend as hb
from . import plonkish as pk

@dataclasses.dataclass(frozen=True)
class CircuitFactory:
    make_ir: Callable[[], pk.PlonkishIR]
    make_setup: Callable[[pk.PlonkishIR, pk.PlonkishConfig, object],
                         pk.PlonkishSetup]  # (ir, cfg, device)


# base-layer registry: the types WITHOUT a real gate set. Every base type
# has its real circuit, served by its own setup / prove / verify functions
# below, so it is empty, as in the JAX package.
BASE_REGISTRY: Dict[int, CircuitFactory] = {}


def _poseidon_factory(log_n: int) -> CircuitFactory:
    return CircuitFactory(
        make_ir=lambda: p2circ.poseidon2_ir(log_n),
        make_setup=lambda ir, cfg, dev: p2circ.poseidon2_setup(
            ir, cfg, device=dev))


def _queue_factory(log_n: int) -> CircuitFactory:
    return CircuitFactory(
        make_ir=lambda: qcirc.queue_ir(log_n),
        make_setup=lambda ir, cfg, dev: qcirc.queue_setup(ir, cfg,
                                                          device=dev))


# recursion-layer registry of the typed surface, the JAX package's: the
# queue-commitment circuit stands in for the scheduler (type 1) and the
# Poseidon2 permutation circuit for the node (2) and the 13 leaves (3-15).
# The real leaf, node and scheduler circuits are synthesized per block by
# `harness.run_block(tower=True)` (circuits/{leaf,node,scheduler}_circuit).
_STAND_IN_LOG_N = 8
RECURSION_REGISTRY: Dict[int, CircuitFactory] = {
    1: _queue_factory(_STAND_IN_LOG_N),
    **{t: _poseidon_factory(_STAND_IN_LOG_N) for t in range(2, 16)},
}

_ENGINE_OVERRIDE: Optional[pk.PlonkishConfig] = None


def _engine_config(psc: ProofSystemConfig) -> pk.PlonkishConfig:
    if _ENGINE_OVERRIDE is not None:
        return _ENGINE_OVERRIDE
    return pk.PlonkishConfig(rate=psc.lde_factor, cap_size=psc.merkle_cap_size,
                             num_queries=max(8, psc.security_bits // 2),
                             final_fri_size=32)


@contextlib.contextmanager
def engine_override(cfg: Optional[pk.PlonkishConfig]):
    """Run setup/prove/verify under an explicit engine config (reduced FRI
    parameters for CPU-scale tests). Setup-cache keys include the active
    config, so overridden setups never collide with the production-config
    cache entries."""
    global _ENGINE_OVERRIDE
    prev = _ENGINE_OVERRIDE
    _ENGINE_OVERRIDE = cfg
    try:
        yield
    finally:
        _ENGINE_OVERRIDE = prev


def _cfg_key() -> tuple:
    c = _ENGINE_OVERRIDE
    if c is None:
        return ()
    return (c.rate, c.cap_size, c.num_queries, c.final_fri_size)


@dataclasses.dataclass
class SetupData:
    ir: pk.PlonkishIR
    setup: pk.PlonkishSetup
    vk: list
    config: pk.PlonkishConfig


_SETUP_CACHE: Dict[tuple, SetupData] = {}
# Set while `base_ir_for_type` runs: `_cached_setup` makes the IR alone
_IR_ONLY = False


def main_vm_geometry_for_capacity(capacity: int,
                                  limb_bits: int = 8) -> mvcirc.VmGeometry:
    """Smallest MainVM trace covering `capacity` cycles per instance
    (and the 2^limb_bits range table). Registers are FULL u256: 32 u8
    limbs here (CPU-testable range table); production uses 16 u16 limbs
    at 2^16+ rows."""
    log_n = max(limb_bits, 4)
    while (1 << log_n) < capacity:
        log_n += 1
    return mvcirc.VmGeometry(log_n, limb_bits=limb_bits,
                             num_limbs=256 // limb_bits)


def main_vm_setup_data(capacity: int,
                       psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                       source=None, device=None
                       ) -> Tuple[SetupData, mvcirc.VmGeometry]:
    """`device=None` means the CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    geo = main_vm_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_main_vm", geo.log_n, geo.limb_bits),
        lambda: mvcirc.main_vm_ir(geo),
        lambda ir, cfg, dev: mvcirc.main_vm_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.MAIN_VM, source, device, psc)
    return sd, geo


def prove_main_vm_instance(inst, capacity: int, source=None, device=None):
    """Prove ONE VmCircuitInstance (type 1): the block's actual per-cycle
    execution trace."""
    device = gl.resolve_device(device)
    sd, geo = main_vm_setup_data(capacity, source=source, device=device)
    return _prove_checked(
        sd, lambda: mvcirc.main_vm_witness(sd.ir, geo, inst, device=device),
        mvcirc.expected_public_inputs(geo, inst), "main_vm", device)


def verify_main_vm_instance(inst, capacity: int, proof, vk=None,
                            device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = main_vm_setup_data(capacity, device=device)
    return _verify_checked(sd, mvcirc.expected_public_inputs(geo, inst),
                           proof, vk, device)


def _cached_setup(key: tuple, make_ir, make_setup, circuit_type: int,
                  source, device,
                  psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG
                  ) -> SetupData:
    """The cached SetupData of `key` (+ device and engine config), built by
    `make_setup(ir, cfg, device)` at its first use; records the VK in
    `source` even when the setup was cached."""
    if _IR_ONLY:
        return SetupData(ir=make_ir(), setup=None, vk=None, config=None)
    key = key + (str(device),) + _cfg_key()
    if key not in _SETUP_CACHE:
        ir = make_ir()
        cfg = _engine_config(psc)
        setup = make_setup(ir, cfg, device)
        _SETUP_CACHE[key] = SetupData(ir=ir, setup=setup, vk=setup.vk(),
                                      config=cfg)
    sd = _SETUP_CACHE[key]
    if source is not None:
        source.set_base_layer_vk(sd.vk, int(circuit_type))
    return sd


def drop_setup(sd: SetupData) -> None:
    """Take `sd` out of the setup cache (alone, or with the program it is
    cached beside), so that its device tensors go once its last holder
    lets go of it."""
    for key in [k for k, v in _SETUP_CACHE.items() if v is sd or (
            isinstance(v, tuple) and len(v) and v[0] is sd)]:
        del _SETUP_CACHE[key]


def _create_setup(layer: str, registry, circuit_type: int,
                  psc: ProofSystemConfig, source=None,
                  device=None) -> SetupData:
    factory = registry[circuit_type]
    sd = _cached_setup((layer, circuit_type), factory.make_ir,
                       factory.make_setup, circuit_type, None, device, psc)
    if source is not None:  # record the VK even when the setup was cached
        if layer == "base":
            source.set_base_layer_vk(sd.vk, circuit_type)
        elif layer == "recursion":
            source.set_recursion_layer_vk(sd.vk, circuit_type)
    return sd


def create_base_layer_setup_data(circuit_type: int, source=None,
                                 device=None) -> SetupData:
    device = gl.resolve_device(device)
    return _create_setup("base", BASE_REGISTRY, circuit_type,
                         BASE_LAYER_PROOF_CONFIG, source, device)


def prove_base_layer_circuit(circuit_type: int, witness, source=None,
                             device=None):
    device = gl.resolve_device(device)
    sd = create_base_layer_setup_data(circuit_type, source, device)
    return pk.prove(sd.ir, sd.setup, witness, sd.config, device=device)


def verify_base_layer_proof(circuit_type: int, proof, vk=None,
                            device=None) -> bool:
    device = gl.resolve_device(device)
    sd = create_base_layer_setup_data(circuit_type, device=device)
    return pk.verify(sd.ir, vk if vk is not None else sd.vk, proof,
                     sd.config, device=device)


def create_recursive_layer_setup_data(circuit_type: int, source=None,
                                      device=None) -> SetupData:
    device = gl.resolve_device(device)
    return _create_setup("recursion", RECURSION_REGISTRY, circuit_type,
                         RECURSION_LAYER_PROOF_CONFIG, source, device)


def prove_recursion_layer_circuit(circuit_type: int, witness, source=None,
                                  device=None):
    device = gl.resolve_device(device)
    sd = create_recursive_layer_setup_data(circuit_type, source, device)
    return pk.prove(sd.ir, sd.setup, witness, sd.config, device=device)


def verify_recursion_layer_proof(circuit_type: int, proof, vk=None,
                                 device=None) -> bool:
    device = gl.resolve_device(device)
    sd = create_recursive_layer_setup_data(circuit_type, device=device)
    return pk.verify(sd.ir, vk if vk is not None else sd.vk, proof,
                     sd.config, device=device)


# -- leaf queue-segment proofs ------------------------------------------------

def _leaf_queue_setup(task, cfg: Optional[pk.PlonkishConfig], device
                      ) -> SetupData:
    k = len(task.encodings)
    assert k >= 1 and k & (k - 1) == 0, "segment length must be a power of two"
    log_n = (k * qcirc.ROWS_PER_PERMUTATION).bit_length() - 1
    cfg = cfg or _engine_config(RECURSION_LAYER_PROOF_CONFIG)
    key = ("leaf_queue", log_n, cfg.rate, cfg.cap_size, cfg.num_queries,
           cfg.final_fri_size, str(device))
    if key not in _SETUP_CACHE:
        ir = qcirc.queue_ir(log_n)
        setup = qcirc.queue_setup(ir, cfg, device=device)
        _SETUP_CACHE[key] = SetupData(ir=ir, setup=setup, vk=setup.vk(),
                                      config=cfg)
    return _SETUP_CACHE[key]


def prove_leaf_queue_segment(task, cfg: Optional[pk.PlonkishConfig] = None,
                             device=None):
    """Prove a leaf task's queue-segment statement with the queue-commitment
    circuit: PIs bind the chunk's head and resulting tail, so the node layer
    can check queue continuity against proven values. Requires a
    power-of-two item count. This is the queue-statement HALF of a leaf
    only: the full leaf (in-circuit verification of the child proofs) is
    circuits/leaf_circuit.py. Returns (proof, vk)."""
    device = gl.resolve_device(device)
    sd = _leaf_queue_setup(task, cfg, device)
    encs = [[int(v) for v in row] for row in task.encodings]
    witness = qcirc.queue_witness(sd.ir, encs, head=task.queue_head,
                                  device=device)
    proof = pk.prove(sd.ir, sd.setup, witness, sd.config, device=device)
    # the proven PIs must equal the witness-side queue states: head capacity
    # lanes (the only head lanes the chain consumes) + the full 12-lane tail
    assert tuple(proof.public_inputs[:4]) == tuple(task.queue_head[8:12])
    assert tuple(proof.public_inputs[4:16]) == tuple(task.queue_tail)
    return proof, sd.vk


def verify_leaf_queue_segment(task, proof, vk,
                              cfg: Optional[pk.PlonkishConfig] = None,
                              device=None) -> bool:
    device = gl.resolve_device(device)
    k = len(task.encodings)
    log_n = (k * qcirc.ROWS_PER_PERMUTATION).bit_length() - 1
    cfg = cfg or _engine_config(RECURSION_LAYER_PROOF_CONFIG)
    if tuple(proof.public_inputs[:4]) != tuple(task.queue_head[8:12]):
        return False
    if tuple(proof.public_inputs[4:16]) != tuple(task.queue_tail):
        return False
    return pk.verify(qcirc.queue_ir(log_n), vk, proof, cfg, device=device)


def _prove_checked(sd: SetupData, make_witness, expected, circuit: str,
                   device):
    with tracing.span("layers.witness", circuit=circuit):
        witness = make_witness()
    proof = pk.prove(sd.ir, sd.setup, witness, sd.config, device=device)
    assert [int(v) for v in proof.public_inputs] == \
        [int(v) % gl.P for v in expected], "instance PI mismatch"
    return proof


def _verify_checked(sd: SetupData, expected, proof, vk, device) -> bool:
    if [int(v) for v in proof.public_inputs] != \
            [int(v) % gl.P for v in expected]:
        return False
    return pk.verify(sd.ir, vk if vk is not None else sd.vk, proof,
                     sd.config, device=device)


# -- RAM permutation (type 8) ------------------------------------------------

def ram_geometry_for_capacity(capacity: int) -> rcirc.RamGeometry:
    """Smallest trace covering `capacity` queries per instance: n >= 256 for
    the byte lookup table; sponge tiles sized so tiles*n/32 >= capacity and
    the dense region (capacity + 1 rows) still fits."""
    log_n = 8
    while True:
        n = 1 << log_n
        tiles = max(1, -(-capacity * rcirc.ROWS_PER_PERMUTATION // n))
        geo = rcirc.RamGeometry(log_n, tiles)
        if geo.capacity >= capacity and geo.capacity + 1 <= n:
            return geo
        log_n += 1


def ram_setup_data(capacity: int,
                   psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                   source=None, device=None
                   ) -> Tuple[SetupData, rcirc.RamGeometry]:
    """`device=None` means the CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    geo = ram_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_ram", geo.log_n, geo.tiles_per_queue),
        lambda: rcirc.ram_ir(geo.log_n, geo.tiles_per_queue),
        lambda ir, cfg, dev: rcirc.ram_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.RAM_PERMUTATION, source, device, psc)
    return sd, geo


def prove_ram_instance(inst_w, challenges, capacity: int, source=None,
                       device=None):
    """Prove ONE RamPermutationInstanceWitness from the decomposer; the
    proof's public inputs are checked against the instance payload before
    returning."""
    device = gl.resolve_device(device)
    sd, geo = ram_setup_data(capacity, source=source, device=device)
    inst = rcirc.instance_inputs(inst_w, challenges)
    return _prove_checked(
        sd, lambda: rcirc.ram_witness(sd.ir, geo, inst, device=device),
        rcirc.instance_public_inputs(geo, inst_w, challenges), "ram", device)


def verify_ram_instance(inst_w, challenges, capacity: int, proof, vk=None,
                        device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = ram_setup_data(capacity, device=device)
    return _verify_checked(
        sd, rcirc.instance_public_inputs(geo, inst_w, challenges), proof, vk,
        device)


# -- events / L1-messages sorter (types 11 / 12) -----------------------------

def events_geometry_for_capacity(capacity: int) -> ecirc.EventsGeometry:
    """Smallest events-sorter trace covering `capacity` elements per
    instance: n >= 256 for the byte table; 3 sponge regions of `tiles` tiles
    each (96 rows per element), one extra slot for the emission lag, and the
    dense region (capacity + 2 rows incl. the PI row) must fit."""
    log_n = 8
    while True:
        n = 1 << log_n
        ept = (n // nrr_mod.ROWS_PER_PERMUTATION) // nrr_mod.CHUNKS
        tiles = max(1, -(-(capacity + 1) // ept))
        geo = ecirc.EventsGeometry(log_n, tiles)
        if geo.capacity >= capacity and geo.capacity + 2 <= n:
            return geo
        log_n += 1


def events_setup_data(capacity: int,
                      psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                      source=None, circuit_type: int = 11, device=None
                      ) -> Tuple[SetupData, ecirc.EventsGeometry]:
    """Types 11 and 12 share the gate set, so one setup serves both."""
    device = gl.resolve_device(device)
    geo = events_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_events", geo.log_n, geo.tiles),
        lambda: ecirc.events_ir(geo.log_n, geo.tiles),
        lambda ir, cfg, dev: ecirc.events_setup(ir, geo, cfg, device=dev),
        circuit_type, source, device, psc)
    return sd, geo


def prove_events_instance(inst_w, challenges, capacity: int, source=None,
                          circuit_type: int = 11, device=None):
    """Prove ONE EventsCircuitInstance from the decomposer (types 11/12 share
    the gate set; only the FS domain tag in the challenges differs)."""
    device = gl.resolve_device(device)
    sd, geo = events_setup_data(capacity, source=source,
                                circuit_type=circuit_type, device=device)
    inst = ecirc.instance_inputs(inst_w, challenges)
    return _prove_checked(
        sd, lambda: ecirc.events_witness(sd.ir, geo, inst, device=device),
        ecirc.instance_public_inputs(geo, inst_w, challenges), "events",
        device)


def verify_events_instance(inst_w, challenges, capacity: int, proof,
                           vk=None, circuit_type: int = 11,
                           device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = events_setup_data(capacity, circuit_type=circuit_type,
                                device=device)
    return _verify_checked(
        sd, ecirc.instance_public_inputs(geo, inst_w, challenges), proof, vk,
        device)


# -- log demuxer (type 4) ----------------------------------------------------

def demux_geometry_for_capacity(capacity: int) -> dcirc.DemuxGeometry:
    """Smallest demux trace covering `capacity` log queries per instance."""
    log_n = 8
    while True:
        n = 1 << log_n
        ept = (n // nrr_mod.ROWS_PER_PERMUTATION) // nrr_mod.CHUNKS
        tiles = max(1, -(-capacity // ept))
        geo = dcirc.DemuxGeometry(log_n, tiles)
        if geo.capacity >= capacity and geo.capacity + 1 <= n:
            return geo
        log_n += 1


def demux_setup_data(capacity: int,
                     psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                     source=None, device=None
                     ) -> Tuple[SetupData, dcirc.DemuxGeometry]:
    device = gl.resolve_device(device)
    geo = demux_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_demux", geo.log_n, geo.tiles),
        lambda: dcirc.demux_ir(geo.log_n, geo.tiles),
        lambda ir, cfg, dev: dcirc.demux_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.LOG_DEMUXER, source, device, psc)
    return sd, geo


def prove_demux_instance(inst_w, capacity: int, source=None, device=None):
    """Prove ONE DemuxCircuitInstance from the decomposer."""
    device = gl.resolve_device(device)
    sd, geo = demux_setup_data(capacity, source=source, device=device)
    return _prove_checked(
        sd, lambda: dcirc.demux_witness(sd.ir, geo, inst_w, device=device),
        dcirc.instance_public_inputs(geo, inst_w), "demux", device)


def verify_demux_instance(inst_w, capacity: int, proof, vk=None,
                          device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = demux_setup_data(capacity, device=device)
    return _verify_checked(sd, dcirc.instance_public_inputs(geo, inst_w),
                           proof, vk, device)


# -- storage sorter (type 9) -------------------------------------------------

def storage_geometry_for_capacity(capacity: int) -> sscirc.StorageGeometry:
    """Smallest storage-sorter trace covering `capacity` elements per
    instance (3 narrow regions, 96 rows per element, one emission-lag
    slot)."""
    log_n = 8
    while True:
        n = 1 << log_n
        ept = (n // nrr_mod.ROWS_PER_PERMUTATION) // nrr_mod.CHUNKS
        tiles = max(1, -(-(capacity + 1) // max(1, ept)))
        geo = sscirc.StorageGeometry(log_n, tiles)
        if geo.capacity >= capacity and geo.capacity + 2 <= n:
            return geo
        log_n += 1


def storage_setup_data(capacity: int,
                       psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                       source=None, device=None
                       ) -> Tuple[SetupData, sscirc.StorageGeometry]:
    device = gl.resolve_device(device)
    geo = storage_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_storage", geo.log_n, geo.tiles),
        lambda: sscirc.storage_ir(geo.log_n, geo.tiles),
        lambda ir, cfg, dev: sscirc.storage_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.STORAGE_SORTER, source, device, psc)
    return sd, geo


def prove_storage_instance(inst_w, challenges, capacity: int, source=None,
                           device=None):
    """Prove ONE StorageCircuitInstance from the decomposer."""
    device = gl.resolve_device(device)
    sd, geo = storage_setup_data(capacity, source=source, device=device)
    inst = sscirc.instance_inputs(inst_w, challenges)
    return _prove_checked(
        sd, lambda: sscirc.storage_witness(sd.ir, geo, inst, device=device),
        sscirc.instance_public_inputs(geo, inst_w, challenges), "storage",
        device)


def verify_storage_instance(inst_w, challenges, capacity: int, proof,
                            vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = storage_setup_data(capacity, device=device)
    return _verify_checked(
        sd, sscirc.instance_public_inputs(geo, inst_w, challenges), proof, vk,
        device)


# -- decommitments sorter (type 2) -------------------------------------------

def decommitts_geometry_for_capacity(capacity: int
                                     ) -> dscirc.DecommittsGeometry:
    """Smallest decommitts-sorter trace covering `capacity` requests per
    instance (3 full-width strips, one 32-row block per request)."""
    log_n = 8
    while True:
        n = 1 << log_n
        tiles = max(1, -(-capacity * dscirc.ROWS_PER_PERMUTATION // n))
        geo = dscirc.DecommittsGeometry(log_n, tiles)
        if geo.capacity >= capacity and geo.capacity + 1 <= n:
            return geo
        log_n += 1


def decommitts_setup_data(capacity: int,
                          psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                          source=None, device=None
                          ) -> Tuple[SetupData, dscirc.DecommittsGeometry]:
    """`device=None` means the CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    geo = decommitts_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_decommitts", geo.log_n, geo.tiles_per_queue),
        lambda: dscirc.decommitts_ir(geo.log_n, geo.tiles_per_queue),
        lambda ir, cfg, dev: dscirc.decommitts_setup(ir, geo, cfg,
                                                     device=dev),
        BaseLayerCircuitType.CODE_DECOMMITTMENTS_SORTER, source, device, psc)
    return sd, geo


def prove_decommitts_instance(inst_w, challenges, capacity: int,
                              source=None, device=None):
    """Prove ONE DecommittsCircuitInstance from the decomposer."""
    device = gl.resolve_device(device)
    sd, geo = decommitts_setup_data(capacity, source=source, device=device)
    inst = dscirc.instance_inputs(inst_w, challenges)
    return _prove_checked(
        sd, lambda: dscirc.decommitts_witness(sd.ir, geo, inst,
                                              device=device),
        dscirc.instance_public_inputs(geo, inst_w, challenges), "decommitts",
        device)


def verify_decommitts_instance(inst_w, challenges, capacity: int, proof,
                               vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = decommitts_setup_data(capacity, device=device)
    return _verify_checked(
        sd, dscirc.instance_public_inputs(geo, inst_w, challenges), proof,
        vk, device)


# -- keccak round function (type 5) ------------------------------------------

def keccak_geometry_for_capacity(capacity: int) -> kcirc.KeccakGeometry:
    """Smallest keccak trace covering `capacity` keccak-f invocations
    (32 rows each)."""
    log_n = 7
    while (1 << log_n) // kcirc.ROWS_PER_INVOCATION < capacity:
        log_n += 1
    return kcirc.KeccakGeometry(log_n)


def keccak_setup_data(capacity: int,
                      psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                      source=None, device=None
                      ) -> Tuple[SetupData, kcirc.KeccakGeometry]:
    device = gl.resolve_device(device)
    geo = keccak_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_keccak", geo.log_n), lambda: kcirc.keccak_ir(geo.log_n),
        lambda ir, cfg, dev: kcirc.keccak_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.KECCAK_ROUND_FUNCTION, source, device, psc)
    return sd, geo


def prove_keccak_instance(inst_w, challenges_gammas, capacity: int,
                          source=None, device=None):
    """Prove ONE RoundFunctionInstanceWitness (type 5) from the decomposer."""
    device = gl.resolve_device(device)
    sd, geo = keccak_setup_data(capacity, source=source, device=device)
    ch, gm = challenges_gammas
    inst = kcirc.instance_inputs(inst_w.invocations, ch, gm, inst_w.acc_in,
                                 inst_w.cnt_in)
    return _prove_checked(
        sd, lambda: kcirc.keccak_witness(sd.ir, geo, inst, device=device),
        kcirc.expected_public_inputs(geo, inst), "keccak", device)


def verify_keccak_instance(inst_w, challenges_gammas, capacity: int, proof,
                           vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = keccak_setup_data(capacity, device=device)
    return _verify_checked(
        sd, kcirc.instance_public_inputs(geo, inst_w, challenges_gammas),
        proof, vk, device)


# -- SHA-256 round function (type 6) -----------------------------------------

def sha256_geometry_for_capacity(capacity: int) -> shcirc.Sha256Geometry:
    """Smallest sha256 trace covering `capacity` compressions (66 rows
    each)."""
    log_n = 8
    while (1 << log_n) // shcirc.ROWS_PER_INVOCATION < capacity:
        log_n += 1
    return shcirc.Sha256Geometry(log_n)


def sha256_setup_data(capacity: int,
                      psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                      source=None, device=None
                      ) -> Tuple[SetupData, shcirc.Sha256Geometry]:
    device = gl.resolve_device(device)
    geo = sha256_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_sha256", geo.log_n), lambda: shcirc.sha256_ir(geo.log_n),
        lambda ir, cfg, dev: shcirc.sha256_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.SHA256_ROUND_FUNCTION, source, device, psc)
    return sd, geo


def prove_sha256_instance(inst_w, challenges_gammas, capacity: int,
                          source=None, device=None):
    """Prove ONE RoundFunctionInstanceWitness (type 6) from the decomposer."""
    device = gl.resolve_device(device)
    sd, geo = sha256_setup_data(capacity, source=source, device=device)
    ch, gm = challenges_gammas
    inst = shcirc.instance_inputs(inst_w.invocations, ch, gm, inst_w.acc_in,
                                  inst_w.cnt_in)
    return _prove_checked(
        sd, lambda: shcirc.sha256_witness(sd.ir, geo, inst, device=device),
        shcirc.expected_public_inputs(geo, inst), "sha256", device)


def verify_sha256_instance(inst_w, challenges_gammas, capacity: int, proof,
                           vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = sha256_setup_data(capacity, device=device)
    return _verify_checked(
        sd, shcirc.instance_public_inputs(geo, inst_w, challenges_gammas),
        proof, vk, device)


# -- L1-messages hasher (type 13) --------------------------------------------

def hasher_geometry_for_capacity(capacity: int) -> lhcirc.HasherGeometry:
    """Smallest hasher trace covering the keccak-f blocks of `capacity`
    serialized L1 messages (88 bytes each, one pad block)."""
    max_blocks = -(-(88 * capacity + 1) // 136)
    log_n = 5
    while (1 << log_n) // lhcirc.ROWS_PER_INVOCATION < max_blocks:
        log_n += 1
    return lhcirc.HasherGeometry(log_n)


def hasher_setup_data(capacity: int,
                      psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                      source=None, device=None
                      ) -> Tuple[SetupData, lhcirc.HasherGeometry]:
    device = gl.resolve_device(device)
    geo = hasher_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_hasher", geo.log_n), lambda: lhcirc.hasher_ir(geo.log_n),
        lambda ir, cfg, dev: lhcirc.hasher_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.L1_MESSAGES_HASHER, source, device, psc)
    return sd, geo


def prove_hasher_instance(inst, capacity: int, source=None, device=None):
    """Prove ONE HasherInstanceInputs (type 13): in-circuit keccak256 of
    the serialized L1-message stream."""
    device = gl.resolve_device(device)
    sd, geo = hasher_setup_data(capacity, source=source, device=device)
    return _prove_checked(
        sd, lambda: lhcirc.hasher_witness(sd.ir, geo, inst, device=device),
        lhcirc.expected_public_inputs(geo, inst), "hasher", device)


def verify_hasher_instance(inst, capacity: int, proof, vk=None,
                           device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = hasher_setup_data(capacity, device=device)
    return _verify_checked(sd, lhcirc.expected_public_inputs(geo, inst),
                           proof, vk, device)


# -- code decommitter (type 3) -----------------------------------------------

def code_decommitter_geometry_for_capacity(capacity: int
                                           ) -> cdcirc.DecommitterGeometry:
    """Smallest decommitter trace covering the sha256 blocks of `capacity`
    32-byte bytecode words (+ padding block)."""
    max_blocks = -(-(32 * capacity + 9) // 64)
    log_n = 7
    while (1 << log_n) // cdcirc.ROWS_PER_INVOCATION < max_blocks:
        log_n += 1
    return cdcirc.DecommitterGeometry(log_n)


def code_decommitter_setup_data(
        capacity: int, psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
        source=None, device=None
        ) -> Tuple[SetupData, cdcirc.DecommitterGeometry]:
    device = gl.resolve_device(device)
    geo = code_decommitter_geometry_for_capacity(capacity)
    sd = _cached_setup(
        ("base_code_decommitter", geo.log_n),
        lambda: cdcirc.decommitter_ir(geo.log_n),
        lambda ir, cfg, dev: cdcirc.decommitter_setup(ir, geo, cfg,
                                                      device=dev),
        BaseLayerCircuitType.CODE_DECOMMITTER, source, device, psc)
    return sd, geo


def prove_code_decommitter_instance(inst, capacity: int, source=None,
                                    device=None):
    """Prove ONE DecommitterInstanceInputs (type 3): in-circuit sha256 of
    one fresh bytecode."""
    device = gl.resolve_device(device)
    sd, geo = code_decommitter_setup_data(capacity, source=source,
                                          device=device)
    return _prove_checked(
        sd, lambda: cdcirc.decommitter_witness(sd.ir, geo, inst,
                                               device=device),
        cdcirc.expected_public_inputs(geo, inst), "code_decommitter", device)


def verify_code_decommitter_instance(inst, capacity: int, proof, vk=None,
                                     device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = code_decommitter_setup_data(capacity, device=device)
    return _verify_checked(sd, cdcirc.expected_public_inputs(geo, inst),
                           proof, vk, device)


# -- ecrecover (type 7) ------------------------------------------------------

def _ecrecover_program() -> eccirc.EcrecoverProgram:
    """The one secp256k1 recovery program, u8 limbs (a 2^8 range table),
    built once."""
    key = ("ecrecover_prog",)
    if key not in _SETUP_CACHE:
        curve = eccirc.secp256k1_params(limb_bits=8)
        _SETUP_CACHE[key] = eccirc.build_ecrecover_program(curve)
    return _SETUP_CACHE[key]


def ecrecover_setup_data(psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                         source=None, device=None
                         ) -> Tuple[SetupData, eccirc.EcrecoverProgram]:
    """Type-7 setup: one full secp256k1 recovery program per proof
    (36,894 active rows at u8 limbs, 286 x 2^16). `device=None` means the
    CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    eprog = _ecrecover_program()
    sd = _cached_setup(
        ("base_ecrecover", eprog.layout.log_n),
        lambda: ffmod.layout_ir(eprog.layout),
        lambda ir, cfg, dev: ffmod.ff_setup(eprog.layout, cfg,
                                            device=dev)[1],
        BaseLayerCircuitType.ECRECOVER, source, device, psc)
    return sd, eprog


def _lift_r_point(r: int, v: int) -> int:
    """y of the lifted R = (r, y) with parity v on secp256k1."""
    p = eccirc.SECP_P
    y = pow((r * r * r + 7) % p, (p + 1) // 4, p)
    assert y * y % p == (r * r * r + 7) % p, "r is not an x-coordinate"
    return y if (y & 1) == (int(v) & 1) else p - y


def _ecrecover_scalars(inv) -> Tuple[int, int, int]:
    n = eccirc.SECP_N
    return (int.from_bytes(inv.msg_hash, "big") % n, inv.r % n, inv.s % n)


def _ecrecover_public_inputs(inv) -> list:
    h, r, s = _ecrecover_scalars(inv)
    return eccirc.expected_public_inputs(_ecrecover_program(), h, r, s,
                                         inv.recovered_point)


def prove_ecrecover_invocation(inv, source=None, device=None):
    """Prove ONE EcrecoverInvocation (type 7) at full secp256k1 scale."""
    device = gl.resolve_device(device)
    sd, eprog = ecrecover_setup_data(source=source, device=device)
    h, r, s = _ecrecover_scalars(inv)
    ry = _lift_r_point(inv.r, inv.v)
    return _prove_checked(
        sd, lambda: eccirc.ecrecover_witness(eprog, sd.ir, h, r, s,
                                             inv.recovered_point, ry,
                                             device=device),
        _ecrecover_public_inputs(inv), "ecrecover", device)


def verify_ecrecover_invocation(inv, proof, vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, _ = ecrecover_setup_data(device=device)
    return _verify_checked(sd, _ecrecover_public_inputs(inv), proof, vk,
                           device)


# -- storage application (type 10) -------------------------------------------

def storage_application_setup_data(
        psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG, source=None,
        depth: int = 256, device=None
        ) -> Tuple[SetupData, sappcirc.PathGeometry]:
    """Type-10 setup: one Blake2s path per proof at the state-tree depth
    (production 256: 3,084 rows x 2,609 columns at 2^12; reduced depths are
    the testing-geometry analogue). `device=None` means the CUDA card."""
    device = gl.resolve_device(device)
    geo = sappcirc.PathGeometry(depth=depth)
    sd = _cached_setup(
        ("base_storage_app", depth, geo.log_n),
        lambda: sappcirc.path_ir(geo),
        lambda ir, cfg, dev: sappcirc.path_setup(ir, geo, cfg, device=dev),
        BaseLayerCircuitType.STORAGE_APPLICATION, source, device, psc)
    return sd, geo


def prove_storage_application_path(inst, source=None, device=None):
    """Prove ONE PathInstanceInputs (type 10): a Blake2s Merkle opening of
    the state tree at the instance's depth (production 256)."""
    device = gl.resolve_device(device)
    sd, geo = storage_application_setup_data(
        source=source, depth=len(inst.path_bits), device=device)
    return _prove_checked(
        sd, lambda: sappcirc.path_witness(sd.ir, geo, inst, device=device),
        sappcirc.expected_public_inputs(geo, inst), "storage_application",
        device)


def verify_storage_application_path(inst, proof, vk=None,
                                    device=None) -> bool:
    device = gl.resolve_device(device)
    sd, geo = storage_application_setup_data(depth=len(inst.path_bits),
                                             device=device)
    return _verify_checked(sd, sappcirc.expected_public_inputs(geo, inst),
                           proof, vk, device)


@dataclasses.dataclass
class StorageApplicationQueryProof:
    """Read + write path proofs for one storage query (the reference proves
    both directions of the tree update inside one instance)."""
    read: object
    write: object

    @property
    def public_inputs(self):
        return list(self.read.public_inputs) + list(self.write.public_inputs)


def prove_storage_application_query(pair, source=None, device=None
                                    ) -> StorageApplicationQueryProof:
    read_inst, write_inst = pair
    return StorageApplicationQueryProof(
        read=prove_storage_application_path(read_inst, source, device),
        write=prove_storage_application_path(write_inst, device=device))


def verify_storage_application_query(pair, qproof, device=None) -> bool:
    read_inst, write_inst = pair
    return (verify_storage_application_path(read_inst, qproof.read,
                                            device=device)
            and verify_storage_application_path(write_inst, qproof.write,
                                                device=device))


# -- the 13 real base circuits ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BaseCircuit:
    """One real base circuit type, for the payloads (inst, challenges,
    capacity) of `witness.oracle.block_payloads`: its setup at a
    GeometryConfig, the prove and verify of one payload entry, and its
    expected public inputs. Those are computable from the payload alone,
    before proving, which is what lets the recursion queues carry real PI
    commitments (the reference's CircuitMaker simulates the commitment the
    same way, src/witness/utils.rs:269-308)."""
    setup: Callable          # (geometry, device) -> SetupData
    prove: Callable          # (inst, challenges, capacity, source, device)
    verify: Callable         # (inst, challenges, capacity, proof, device)
    public_inputs: Callable  # (inst, challenges, capacity) -> list


def _sized(ctype: int, setup_data, prove, verify, geometry_for, pis,
           challenged: bool, **kw) -> BaseCircuit:
    """A type whose circuit is sized by its capacity; a `challenged` type
    takes the decomposer's binding challenges; `kw` goes to its setup,
    prove and verify (types 11/12: the circuit type)."""
    ch = (lambda c: (c,)) if challenged else (lambda c: ())
    return BaseCircuit(
        lambda g, dev: setup_data(base_capacity(g, ctype), device=dev,
                                  **kw)[0],
        lambda i, c, cap, src, dev: prove(i, *ch(c), cap, source=src,
                                          device=dev, **kw),
        lambda i, c, cap, pr, dev: verify(i, *ch(c), cap, pr, device=dev,
                                          **kw),
        lambda i, c, cap: pis(geometry_for(cap), i, *ch(c)))


_T = BaseLayerCircuitType
BASE_CIRCUITS: Dict[int, BaseCircuit] = {
    1: _sized(_T.MAIN_VM, main_vm_setup_data, prove_main_vm_instance,
              verify_main_vm_instance, main_vm_geometry_for_capacity,
              mvcirc.expected_public_inputs, False),
    2: _sized(_T.CODE_DECOMMITTMENTS_SORTER, decommitts_setup_data,
              prove_decommitts_instance, verify_decommitts_instance,
              decommitts_geometry_for_capacity,
              dscirc.instance_public_inputs, True),
    3: _sized(_T.CODE_DECOMMITTER, code_decommitter_setup_data,
              prove_code_decommitter_instance,
              verify_code_decommitter_instance,
              code_decommitter_geometry_for_capacity,
              cdcirc.expected_public_inputs, False),
    4: _sized(_T.LOG_DEMUXER, demux_setup_data, prove_demux_instance,
              verify_demux_instance, demux_geometry_for_capacity,
              dcirc.instance_public_inputs, False),
    5: _sized(_T.KECCAK_ROUND_FUNCTION, keccak_setup_data,
              prove_keccak_instance, verify_keccak_instance,
              keccak_geometry_for_capacity, kcirc.instance_public_inputs,
              True),
    6: _sized(_T.SHA256_ROUND_FUNCTION, sha256_setup_data,
              prove_sha256_instance, verify_sha256_instance,
              sha256_geometry_for_capacity, shcirc.instance_public_inputs,
              True),
    # one proof per invocation: the instance's first
    7: BaseCircuit(
        lambda g, dev: ecrecover_setup_data(device=dev)[0],
        lambda i, c, cap, src, dev: prove_ecrecover_invocation(
            i.invocations[0], source=src, device=dev),
        lambda i, c, cap, pr, dev: verify_ecrecover_invocation(
            i.invocations[0], pr, device=dev),
        lambda i, c, cap: _ecrecover_public_inputs(i.invocations[0])),
    8: _sized(_T.RAM_PERMUTATION, ram_setup_data, prove_ram_instance,
              verify_ram_instance, ram_geometry_for_capacity,
              rcirc.instance_public_inputs, True),
    9: _sized(_T.STORAGE_SORTER, storage_setup_data, prove_storage_instance,
              verify_storage_instance, storage_geometry_for_capacity,
              sscirc.instance_public_inputs, True),
    # instances are single PATHS (read / write flattened), each one proof
    # slot of the recursion tower; the circuit is sized by the tree depth
    10: BaseCircuit(
        lambda g, dev: storage_application_setup_data(
            depth=g.storage_tree_depth, device=dev)[0],
        lambda i, c, cap, src, dev: prove_storage_application_path(
            i, source=src, device=dev),
        lambda i, c, cap, pr, dev: verify_storage_application_path(
            i, pr, device=dev),
        lambda i, c, cap: sappcirc.expected_public_inputs(
            sappcirc.PathGeometry(depth=len(i.path_bits)), i)),
    **{int(t): _sized(t, events_setup_data, prove_events_instance,
                      verify_events_instance, events_geometry_for_capacity,
                      ecirc.instance_public_inputs, True,
                      circuit_type=int(t))
       for t in (_T.EVENTS_SORTER, _T.L1_MESSAGES_SORTER)},
    13: _sized(_T.L1_MESSAGES_HASHER, hasher_setup_data,
               prove_hasher_instance, verify_hasher_instance,
               hasher_geometry_for_capacity, lhcirc.expected_public_inputs,
               False),
}

REAL_BASE_CIRCUITS = set(BASE_CIRCUITS)


def real_base_instance_public_inputs(ctype: int, inst_w, challenges,
                                     capacity: int):
    """Expected public inputs of a real base circuit instance, from the
    decomposer payload alone."""
    return BASE_CIRCUITS[ctype].public_inputs(inst_w, challenges, capacity)


def base_setup_for_type(ctype: int, geometry, device=None) -> SetupData:
    """The SetupData (ir / setup / vk / engine config) that the prove
    function of `ctype` uses at this geometry — the one accessor the
    recursion layers need to verify base proofs in-circuit (the reference
    passes base VKs into create_leaf_witnesses,
    recursive_aggregation.rs:71-161)."""
    return BASE_CIRCUITS[ctype].setup(geometry, device)


def base_ir_for_type(ctype: int, geometry) -> pk.PlonkishIR:
    """The IR of `base_setup_for_type(ctype, geometry)` alone, made without
    its setup and cached nowhere: the base circuit's shape, on the host."""
    global _IR_ONLY
    _IR_ONLY = True
    try:
        return BASE_CIRCUITS[ctype].setup(geometry, "cpu").ir
    finally:
        _IR_ONLY = False


def prove_base_instance(ctype: int, inst_w, challenges, capacity: int,
                        source=None, device=None):
    """Prove one instance of base type `ctype` from its payload (an entry
    of `witness.oracle.block_payloads`): the JAX package's `harness.py`
    dispatch. Type 7 proves the instance's first invocation, type 10 one
    path."""
    return BASE_CIRCUITS[ctype].prove(inst_w, challenges, capacity, source,
                                      device)


def verify_base_instance(ctype: int, inst_w, challenges, capacity: int,
                         proof, device=None) -> bool:
    """Verify a proof of `prove_base_instance`, its public inputs checked
    against the payload's first."""
    return BASE_CIRCUITS[ctype].verify(inst_w, challenges, capacity, proof,
                                       device)


# -- EIP-4844 (the blob branch) ----------------------------------------------

def create_eip4844_setup_data(n_elements: int = 4096, limb_bits: int = 8,
                              psc: ProofSystemConfig = BASE_LAYER_PROOF_CONFIG,
                              source=None, device=None):
    """The blob-fold circuit's setup at `n_elements` chunks (the reference's
    prover_utils.rs eip4844 surface) and its program. `source` is accepted
    for the JAX package's signature (its data sources keep no blob VK).
    `device=None` means the CUDA card.

    Raises ValueError where the engine config's final FRI size is not below
    the circuit's LDE size (16 elements at u8 limbs is a 2^8-row circuit,
    an LDE of 512 points at rate 2): FRI would not fold, which the FRI
    verifier rejects and the in-circuit verifier cannot express. The caller
    picks a config that folds (`full_chain.prove_block_full_chain`'s
    `blob_cfg`)."""
    device = gl.resolve_device(device)
    key = ("eip4844", n_elements, limb_bits, str(device)) + _cfg_key()
    if key not in _SETUP_CACHE:
        prog = e4.build_eip4844_program(n_elements, limb_bits=limb_bits)
        cfg = _engine_config(psc)
        n_comm = cfg.rate << prog.layout.log_n
        if cfg.final_fri_size >= n_comm:
            raise ValueError(
                f"final FRI size {cfg.final_fri_size} does not fold the "
                f"blob circuit's {n_comm}-point LDE ({n_elements} elements)")
        ir, setup = ffmod.ff_setup(prog.layout, cfg, device=device)
        sd = SetupData(ir=ir, setup=setup, vk=setup.vk(), config=cfg)
        _SETUP_CACHE[key] = (sd, prog)
    return _SETUP_CACHE[key]


def prove_eip4844(elements, x: int, n_elements: int = 4096,
                  limb_bits: int = 8, source=None, device=None):
    """Prove the blob-opening fold for one blob (reference: prove_eip4844,
    src/prover_utils.rs eip4844 surface)."""
    device = gl.resolve_device(device)
    sd, prog = create_eip4844_setup_data(n_elements, limb_bits,
                                         source=source, device=device)
    inst = e4.instance_inputs(elements, x, device=device)
    return _prove_checked(
        sd, lambda: e4.eip4844_witness(prog, sd.ir, inst, device=device),
        e4.expected_public_inputs(prog, inst), "eip4844", device)


def verify_eip4844(elements, x: int, proof, n_elements: int = 4096,
                   limb_bits: int = 8, vk=None, device=None) -> bool:
    device = gl.resolve_device(device)
    sd, prog = create_eip4844_setup_data(n_elements, limb_bits,
                                         device=device)
    inst = e4.instance_inputs(elements, x, device=device)
    return _verify_checked(sd, e4.expected_public_inputs(prog, inst), proof,
                           vk, device)


# -- compression layers: in-circuit verifier proofs ---------------------------
#
# Mode k's circuit verifies the previous layer's proof in-circuit
# (reference: aux_layer/compression_modes/mode_{1..5}.rs and the
# create/prove/verify_compression_layer_* surface, prover_utils.rs:566-711).
# The circuit is the synthesized verifier (circuits/verifier_circuit.py);
# mode 1's inner proof is the scheduler's, mode k > 1's is mode k-1's. Each
# function takes an optional `watch` (a `tracing.Stopwatch`) that closes a
# lap after each step: synthesis, finalize, setup, fill, prove.

@dataclasses.dataclass
class CompressionSetup:
    sd: SetupData
    builder: object
    layout: object


def compression_engine_config(mode: int) -> pk.PlonkishConfig:
    return _engine_config(COMPRESSION_PROOF_CONFIGS[CompressionMode(mode)])


def _lap(watch, name: str):
    if watch is not None:
        watch.lap(name)


def create_compression_layer_setup_data(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        outer_cfg: Optional[pk.PlonkishConfig] = None, device=None,
        watch=None) -> CompressionSetup:
    """`device=None` means the CUDA card."""
    device = gl.resolve_device(device)
    outer_cfg = outer_cfg or compression_engine_config(mode)
    key = ("compression", mode, inner_ir.log_n, inner_ir.num_witness,
           inner_cfg.rate, inner_cfg.cap_size, inner_cfg.num_queries,
           inner_cfg.final_fri_size, outer_cfg.rate, outer_cfg.num_queries,
           outer_cfg.cap_size, outer_cfg.final_fri_size, str(device))
    if key not in _SETUP_CACHE:
        b, lay = vc.synthesize_verifier(inner_ir, inner_cfg, slots=8)
        _lap(watch, "synthesis")
        built = b.finalize()
        _lap(watch, "finalize")
        setup = built.setup(outer_cfg, device=device)
        _lap(watch, "setup")
        sd = SetupData(ir=built.ir, setup=setup, vk=setup.vk(),
                       config=outer_cfg)
        _SETUP_CACHE[key] = CompressionSetup(sd=sd, builder=b, layout=lay)
    return _SETUP_CACHE[key]


def prove_compression_layer_circuit(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        inner_vk, inner_proof,
        outer_cfg: Optional[pk.PlonkishConfig] = None, device=None,
        watch=None):
    device = gl.resolve_device(device)
    cs = create_compression_layer_setup_data(mode, inner_ir, inner_cfg,
                                             outer_cfg, device, watch)
    asg = vc.verifier_assignments(cs.layout, inner_vk, inner_proof)
    witness = cs.builder.fill_witness(asg, device=device)
    _lap(watch, "fill")
    proof = pk.prove(cs.sd.ir, cs.sd.setup, witness, cs.sd.config,
                     device=device)
    del witness
    _lap(watch, "prove")
    expected = vc.verifier_public_inputs(inner_vk, inner_proof)
    assert [int(v) for v in proof.public_inputs] == expected, \
        "compression PI mismatch (inner vk + inner public inputs)"
    return proof


def verify_compression_layer_proof(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        proof, vk=None, expected_inner_vk=None,
        outer_cfg: Optional[pk.PlonkishConfig] = None,
        device=None) -> bool:
    device = gl.resolve_device(device)
    cs = create_compression_layer_setup_data(mode, inner_ir, inner_cfg,
                                             outer_cfg, device)
    if expected_inner_vk is not None:
        k = len(expected_inner_vk)
        if [int(v) for v in proof.public_inputs[:k]] != \
                [int(v) % gl.P for v in expected_inner_vk]:
            return False
    return pk.verify(cs.sd.ir, vk if vk is not None else cs.sd.vk, proof,
                     cs.sd.config, device=device)


class CompressionChain:
    """Pluggable prove/verify pair for
    compression.compute_compression_circuits where every mode is a real
    proof of verification of the previous layer. `stats[mode]` holds the
    shape and the seconds of synthesis, finalize, setup, fill, prove and
    verify of each mode this chain proved (setup steps only where the setup
    was not cached), and, on a CUDA device, the peak memory and launches of
    its setup and prove."""

    def __init__(self, scheduler_ir: pk.PlonkishIR,
                 scheduler_cfg: pk.PlonkishConfig, scheduler_vk,
                 outer_cfgs: Optional[Dict[int, pk.PlonkishConfig]] = None,
                 wrapper_mode: Optional[int] = None, device=None):
        """`wrapper_mode` routes that mode through the compression-FOR-
        WRAPPER path (Bn256 Poseidon2 trees/transcript) — the reference's
        final mode before the SNARK (WrapperConfig.get_final_compression_
        type, proof_wrapper_utils/mod.rs:88-92)."""
        self.device = gl.resolve_device(device)
        self._inner: Dict[int, Tuple] = {
            1: (scheduler_ir, scheduler_cfg, scheduler_vk)}
        self._outer_cfgs = outer_cfgs or {}
        self._wrapper_mode = wrapper_mode
        self.stats: Dict[int, Dict] = {}

    def _outer(self, mode: int) -> Optional[pk.PlonkishConfig]:
        return self._outer_cfgs.get(mode)

    def prove_fn(self, mode: int, prev_proof):
        ir, cfg, vk = self._inner[mode]
        watch = tracing.Stopwatch(self.device)
        if mode == self._wrapper_mode:
            cs = create_compression_for_wrapper_setup_data(
                mode, ir, cfg, self._outer(mode), self.device, watch)
            proof = prove_compression_for_wrapper_circuit(
                mode, ir, cfg, vk, prev_proof, self._outer(mode),
                self.device, watch)
            out_vk = cs.vk_fr
        else:
            cs = create_compression_layer_setup_data(
                mode, ir, cfg, self._outer(mode), self.device, watch)
            proof = prove_compression_layer_circuit(
                mode, ir, cfg, vk, prev_proof, self._outer(mode),
                self.device, watch)
            out_vk = cs.sd.vk
        self.stats[mode] = watch.done(
            log_n=cs.sd.ir.log_n, width=cs.sd.ir.num_witness,
            public_inputs=len(cs.sd.ir.public_input_cells),
            gates=cs.builder.num_gates,
            permutations=len(cs.builder.perms),
            for_wrapper=mode == self._wrapper_mode)
        self._inner[mode + 1] = (cs.sd.ir, cs.sd.config, out_vk)
        return proof, out_vk

    def verify_fn(self, mode: int, proof, vk) -> bool:
        ir, cfg, inner_vk = self._inner[mode]
        watch = tracing.Stopwatch(self.device)
        verify = (verify_compression_for_wrapper_proof
                  if mode == self._wrapper_mode
                  else verify_compression_layer_proof)
        ok = verify(mode, ir, cfg, proof, vk, expected_inner_vk=inner_vk,
                    outer_cfg=self._outer(mode), device=self.device)
        watch.lap("verify")
        if mode in self.stats:  # the verify after the prove
            self.stats[mode].setdefault("verify_s", watch.out["verify_s"])
        return ok

    def final_shape(self, final_mode: int):
        """(ir, cfg, vk) of the final mode's own circuit (populated by
        prove_fn(final_mode, ...))."""
        return self._inner[final_mode + 1]


# -- compression FOR WRAPPER: Bn256-Poseidon2-hashed final mode ---------------
#
# The reference's last compression step re-proves the same verifier circuit
# with the FRI trees and transcript hashed by a Bn256 Poseidon2 sponge, so
# the BN254 PLONK WrapperCircuit can consume the proof with native-field
# hash gates (create/prove/verify_compression_for_wrapper_*,
# src/prover_utils.rs:823-967; hasher types proof_wrapper_utils/mod.rs:30-31).
# The trees are hashed on the device by `ops/cuda_kernels.bn254_hash_rows`
# and `bn254_hash_pairs`; the transcript is host Python.

@dataclasses.dataclass
class ForWrapperSetup:
    sd: SetupData          # ir + polynomial setup (hash-independent)
    builder: object
    layout: object
    backend: object        # hash_backend.Bn254Backend
    vk_fr: list            # Bn254 cap of the setup tree (THE for-wrapper VK)
    setup_tree: object     # Bn254Tree over the setup LDE


def for_wrapper_engine_config(mode: int) -> pk.PlonkishConfig:
    return _engine_config(
        COMPRESSION_FOR_WRAPPER_PROOF_CONFIGS[CompressionMode(mode)])


def create_compression_for_wrapper_setup_data(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        outer_cfg: Optional[pk.PlonkishConfig] = None, device=None,
        watch=None) -> ForWrapperSetup:
    """`device=None` means the CUDA card."""
    device = gl.resolve_device(device)
    outer_cfg = outer_cfg or for_wrapper_engine_config(mode)
    key = ("compression_fw", mode, inner_ir.log_n, inner_ir.num_witness,
           inner_cfg.rate, inner_cfg.cap_size, inner_cfg.num_queries,
           inner_cfg.final_fri_size, outer_cfg.rate, outer_cfg.num_queries,
           outer_cfg.cap_size, outer_cfg.final_fri_size, str(device))
    if key not in _SETUP_CACHE:
        b, lay = vc.synthesize_verifier(inner_ir, inner_cfg, slots=8)
        _lap(watch, "synthesis")
        built = b.finalize()
        _lap(watch, "finalize")
        setup = built.setup(outer_cfg, device=device)
        backend = hb.Bn254Backend(device)
        setup_cols = gl.concatenate(
            [setup.const_cols, setup.sigma_cols, setup.table_cols], axis=0)
        tree = backend.commit_rows(nt.coset_lde(setup_cols, outer_cfg.rate),
                                   outer_cfg.cap_size)
        _lap(watch, "setup")
        sd = SetupData(ir=built.ir, setup=setup, vk=tree.cap,
                       config=outer_cfg)
        _SETUP_CACHE[key] = ForWrapperSetup(
            sd=sd, builder=b, layout=lay, backend=backend, vk_fr=tree.cap,
            setup_tree=tree)
    return _SETUP_CACHE[key]


def prove_compression_for_wrapper_circuit(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        inner_vk, inner_proof,
        outer_cfg: Optional[pk.PlonkishConfig] = None, device=None,
        watch=None):
    device = gl.resolve_device(device)
    fw = create_compression_for_wrapper_setup_data(
        mode, inner_ir, inner_cfg, outer_cfg, device, watch)
    asg = vc.verifier_assignments(fw.layout, inner_vk, inner_proof)
    witness = fw.builder.fill_witness(asg, device=device)
    _lap(watch, "fill")
    proof = pk.prove(fw.sd.ir, fw.sd.setup, witness, fw.sd.config,
                     backend=fw.backend,
                     backend_setup=(fw.vk_fr, fw.setup_tree), device=device)
    del witness
    _lap(watch, "prove")
    expected = vc.verifier_public_inputs(inner_vk, inner_proof)
    assert [int(v) for v in proof.public_inputs] == expected, \
        "for-wrapper PI mismatch (inner vk + inner public inputs)"
    return proof


def verify_compression_for_wrapper_proof(
        mode: int, inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
        proof, vk=None, expected_inner_vk=None,
        outer_cfg: Optional[pk.PlonkishConfig] = None,
        device=None) -> bool:
    device = gl.resolve_device(device)
    fw = create_compression_for_wrapper_setup_data(
        mode, inner_ir, inner_cfg, outer_cfg, device)
    if expected_inner_vk is not None:
        k = len(expected_inner_vk)
        if [int(v) for v in proof.public_inputs[:k]] != \
                [int(v) % gl.P for v in expected_inner_vk]:
            return False
    return pk.verify(fw.sd.ir, vk if vk is not None else fw.vk_fr, proof,
                     fw.sd.config, device=device, backend=fw.backend)
