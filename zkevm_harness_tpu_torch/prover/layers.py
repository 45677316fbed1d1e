"""Typed per-layer prover surface: setup/prove/verify per circuit type.

Counterpart of the JAX package's `prover/layers.py`, in part: for each
ported base circuit type a `*_geometry_for_capacity`, a `*_setup_data`, a
`prove_*_instance` and a `verify_*_instance`, with what they need
(`SetupData`, the setup cache, the engine config and its override). Ported
types: the MainVM (1), the decommitments sorter (2), the code decommitter
(3), the log demuxer (4), the keccak (5) and SHA-256 (6) round functions,
the RAM permutation (8), the storage sorter (9), the events / L1-messages
sorter (11 / 12, one gate set) and the L1-messages hasher (13). The other
circuit types, the registries and the recursion /
compression layers are not ported yet; a circuit type ported later is added
here, and the module imports only the circuits that exist in this package.

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
from typing import Dict, Optional, Tuple

from ..circuits import decommitter_circuit as cdcirc
from ..circuits import decommitts_sorter_circuit as dscirc
from ..circuits import events_sorter_circuit as ecirc
from ..circuits import keccak_circuit as kcirc
from ..circuits import linear_hasher_circuit as lhcirc
from ..circuits import log_demux_circuit as dcirc
from ..circuits import main_vm_circuit as mvcirc
from ..circuits import narrow_region as nrr_mod
from ..circuits import ram_permutation_circuit as rcirc
from ..circuits import sha256_circuit as shcirc
from ..circuits import storage_sorter_circuit as sscirc
from ..circuits.types import (BASE_LAYER_PROOF_CONFIG, BaseLayerCircuitType,
                              ProofSystemConfig)
from ..ops import goldilocks as gl
from ..utils import tracing
from . import plonkish as pk

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
