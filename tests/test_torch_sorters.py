"""The port's memory and log subsystem (RAM permutation, events sorter,
storage sorter, log demuxer) on the golden 200-cycle block, held against the
JAX package and the committed golden artifacts
(`tools/gen_sorter_golden.py`), bit for bit (tolerance 0).

Tier-1 tests stay cheap: the JAX side is host Python (VM trace, demux and
dedup, IRs, constant rows, copy cycles, the Poseidon2 circuit's row trace)
or the committed artifacts (the golden proofs' public inputs and witness
caps, the golden VKs). Everything that compiles the JAX package's queue
chains, builds its witnesses, or runs a whole setup and proof is `slow`.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu.circuits import events_sorter_circuit as jec
from zkevm_harness_tpu.circuits import log_demux_circuit as jdc
from zkevm_harness_tpu.circuits import poseidon2_circuit as jp2c
from zkevm_harness_tpu.circuits import ram_permutation_circuit as jrc
from zkevm_harness_tpu.circuits import storage_sorter_circuit as jsc
from zkevm_harness_tpu.circuits.types import testing_geometry as jgeometry
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu.vm import isa as jisa
from zkevm_harness_tpu.vm.environment import (DefaultPrecompilesProcessor,
                                              InMemoryEventSink,
                                              InMemoryStorage,
                                              SimpleDecommitter, SimpleMemory)
from zkevm_harness_tpu.vm.interpreter import run_vm as jrun_vm
from zkevm_harness_tpu.vm.state import (BlockProperties, ProvingToolset,
                                        create_vm)
from zkevm_harness_tpu.witness import log_demux as jwld
from zkevm_harness_tpu.witness import oracle as joracle
from zkevm_harness_tpu.witness import ram_permutation as jwram
from zkevm_harness_tpu.witness import sorters as jwsort
from zkevm_harness_tpu.witness.tracer import WitnessTracer as JTracer
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import events_sorter_circuit as tec
from zkevm_harness_tpu_torch.circuits import log_demux_circuit as tdc
from zkevm_harness_tpu_torch.circuits import ram_permutation_circuit as trc
from zkevm_harness_tpu_torch.circuits import storage_sorter_circuit as tsc
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import serde as tserde
from zkevm_harness_tpu_torch.witness import log_demux as twld
from zkevm_harness_tpu_torch.witness import oracle as toracle
from zkevm_harness_tpu_torch.witness import ram_permutation as twram
from zkevm_harness_tpu_torch.witness import sorters as twsort

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CAP = golden.SORTER_CAPACITY
TCFG = tpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
JCFG = jpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
NAMES = ("ram", "events", "storage", "demux")


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _golden_proof(name):
    return convert.proof_from_json(_load(f"{name}_log8_proof.json"))


def _jax_ram_cycles(geo):
    """The copy cycles that the JAX package's `ram_setup` lists inline."""
    C, cycles = jrc._DenseCols, []
    D, B = geo.dense_base, geo.blocks_per_tile
    for q in range(geo.capacity):
        t, r = q // B, (q % B) * jrc.ROWS_PER_PERMUTATION
        ub = jrc.TILE_WIDTH * t
        sb = jrc.TILE_WIDTH * (geo.tiles_per_queue + t)
        for j in range(8):
            cycles.append([(ub + j, r), (D + C.U_ENC + j, q + 1)])
            cycles.append([(sb + j, r), (D + C.S_ENC + j, q + 1)])
        cycles.append([(ub + 12, r), (sb + 12, r), (D + C.V, q + 1)])
    return cycles


def _ints(x):
    """Nested tuples / lists / arrays / dataclasses of field values as plain
    Python structures of ints, for exact comparison across the packages."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _ints(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return _ints(x.tolist())
    if isinstance(x, (list, tuple)):
        return [_ints(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return x


def _jax_trace():
    tracer = JTracer(1000)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=jgeometry())
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    jrun_vm(vm, golden.main_vm_block(jisa), 1000)
    assert vm.finished
    return tracer


def _streams(tracer):
    demuxed = {k: [q for _, q in v] for k, v in
               toracle.demux_log_queue(tracer.final_log_queue()).items()}
    return dict(memory=[q for _, q in tracer.memory_queries],
                log=[q for _, q in tracer.final_log_queue()], **demuxed)


@pytest.fixture(scope="module")
def streams():
    return _streams(golden.trace_main_vm_block())


def _port_artifacts(name, streams, capacity):
    if name == "ram":
        return twram.compute_ram_circuit_snapshots(streams["memory"],
                                                   capacity, device="cpu")
    if name == "events":
        return twsort.compute_events_circuit_artifacts(
            streams["events"], capacity, circuit_type=11, device="cpu")
    if name == "storage":
        return twsort.compute_storage_circuit_artifacts(
            streams["storage"], capacity, device="cpu")
    return twld.compute_log_demux_artifacts(streams["log"], capacity,
                                            device="cpu")


def _jax_artifacts(name, streams, capacity):
    if name == "ram":
        return jwram.compute_ram_circuit_snapshots(streams["memory"], capacity)
    if name == "events":
        return jwsort.compute_events_circuit_artifacts(
            streams["events"], capacity, circuit_type=11)
    if name == "storage":
        return jwsort.compute_storage_circuit_artifacts(streams["storage"],
                                                        capacity)
    return jwld.compute_log_demux_artifacts(streams["log"], capacity)


# the circuit modules, geometry function, and the instance's expected
# public inputs of each type
MODS = {"ram": (trc, jrc), "events": (tec, jec), "storage": (tsc, jsc),
        "demux": (tdc, jdc)}
GEO_OF = {"ram": tly.ram_geometry_for_capacity,
          "events": tly.events_geometry_for_capacity,
          "storage": tly.storage_geometry_for_capacity,
          "demux": tly.demux_geometry_for_capacity}


def _ir(mod, geo):
    if mod in (trc, jrc):
        return mod.ram_ir(geo.log_n, geo.tiles_per_queue)
    make = {tec: tec.events_ir, jec: jec.events_ir, tsc: tsc.storage_ir,
            jsc: jsc.storage_ir, tdc: tdc.demux_ir, jdc: jdc.demux_ir}[mod]
    return make(geo.log_n, geo.tiles)


def _jgeo(name, geo):
    """The JAX package's geometry of the same shape."""
    return getattr(MODS[name][1], type(geo).__name__)(
        *dataclasses.astuple(geo))


def _expected_pis(name, geo, art, k=0):
    mod = MODS[name][0]
    inst = art.instances[k]
    if name == "demux":
        return mod.instance_public_inputs(geo, inst)
    return mod.instance_public_inputs(geo, inst, art.challenges)


def _witness(name, mod, ir, geo, art, k=0, **kw):
    inst = art.instances[k]
    if name == "demux":
        return mod.demux_witness(ir, geo, inst, **kw)
    payload = mod.instance_inputs(inst, art.challenges)
    fn = {"ram": "ram_witness", "events": "events_witness",
          "storage": "storage_witness"}[name]
    return getattr(mod, fn)(ir, geo, payload, **kw)


# ---------------------------------------------------------------------------
# tier-1
# ---------------------------------------------------------------------------

def test_geometries_are_those_of_the_golden_artifacts():
    assert tly.ram_geometry_for_capacity(CAP["ram"]) == trc.RamGeometry(8, 1)
    assert tly.events_geometry_for_capacity(CAP["events"]) == \
        tec.EventsGeometry(8, 2)
    assert tly.storage_geometry_for_capacity(CAP["storage"]) == \
        tsc.StorageGeometry(8, 11)
    assert tly.demux_geometry_for_capacity(CAP["demux"]) == \
        tdc.DemuxGeometry(8, 3)


def test_demux_log_queue_and_dedup_events_equal(streams):
    jtracer = _jax_trace()
    tlog = golden.trace_main_vm_block().final_log_queue()
    jlog = jtracer.final_log_queue()
    assert [(c, dataclasses.asdict(q)) for c, q in tlog] == \
        [(c, dataclasses.asdict(q)) for c, q in jlog]
    tdem, jdem = toracle.demux_log_queue(tlog), joracle.demux_log_queue(jlog)
    assert {k: len(v) for k, v in tdem.items()} == \
        {k: len(v) for k, v in jdem.items()}
    assert len(tdem["storage"]) == 21 and len(tdem["events"]) == 20
    for k in tdem:
        assert [(c, dataclasses.asdict(q)) for c, q in tdem[k]] == \
            [(c, dataclasses.asdict(q)) for c, q in jdem[k]]
    # dedup: a forward event and its rollback cancel, others stay in order
    ev = [q for _, q in tdem["events"]]
    rolled = [dataclasses.replace(ev[1], rollback=True),
              dataclasses.replace(ev[4], rollback=True)]
    for queries in (ev, ev + rolled):
        got = toracle.dedup_events(queries)
        want = joracle.dedup_events(queries)
        assert [dataclasses.asdict(q) for q in got] == \
            [dataclasses.asdict(q) for q in want]
    assert len(toracle.dedup_events(ev + rolled)) == len(ev) - 2
    assert toracle._instances_for(21, 8) == joracle._instances_for(21, 8) == 3
    assert toracle._instances_for(0, 8) == 1


@pytest.mark.parametrize("name", NAMES)
def test_decomposer_public_inputs_equal_the_golden_proof(name, streams):
    """The port's decomposer on the golden block: its first instance's
    public inputs (queue heads and tails, challenges, accumulators, counts)
    are those of the JAX package's golden proof."""
    art = _port_artifacts(name, streams, CAP[name])
    geo = GEO_OF[name](CAP[name])
    want = _golden_proof(name).public_inputs
    assert [int(v) % P for v in _expected_pis(name, geo, art)] == \
        [int(v) for v in want]


@pytest.mark.parametrize("name", NAMES)
def test_ir_const_rows_and_copy_wiring_equal(name):
    tmod, jmod = MODS[name]
    geo = GEO_OF[name](CAP[name])
    jgeo = _jgeo(name, geo)
    tir, jir = _ir(tmod, geo), _ir(jmod, jgeo)
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "lookup_sets", "gate_part_degrees"):
        assert getattr(tir, field) == getattr(jir, field), field
    assert tir.gate_part_degrees is None  # the unstratified quotient
    assert len(tir.lookup_tables) == len(jir.lookup_tables) == 1
    assert (tir.lookup_tables[0] == jir.lookup_tables[0]).all()
    want = np.asarray(jmod._const_rows(jgeo), dtype=object).astype(np.uint64)
    assert np.array_equal(tmod._const_rows(geo), want)
    # the successor of every cell, from the pairs and from the JAX cycles
    n = geo.n
    wiring = tpk.wire_copy_pairs(n, *tmod._copy_pairs(geo))
    got = np.arange(tir.num_witness * n, dtype=np.int64)
    got[wiring.cells] = wiring.succ
    jcycles = (jmod._copy_cycles(jgeo) if name != "ram"
               else _jax_ram_cycles(jgeo))
    perm = jpk.apply_copy_cycles(jpk.identity_permutation(jir.num_witness, n),
                                 jcycles)
    assert np.array_equal(got, (perm[:, :, 0] * n + perm[:, :, 1]).ravel())


def test_wire_copy_pairs_equals_the_sequential_merge_and_refuses_shared_pairs():
    """Fresh cells joined to shared ones, in several orders: the vectorised
    merge gives the successors of the JAX package's `apply_copy_cycles`; a
    pair of two shared cells is refused."""
    n, cols = 8, 4
    rng = np.random.default_rng(3)
    shared = [(3, 1), (3, 5), (2, 0)]
    fresh = [(c, r) for c in range(3) for r in range(n)
             if (c, r) not in shared]
    rng.shuffle(fresh)
    cycles = [[fresh[i], shared[i % 3]] for i in range(12)]
    cycles.append([fresh[12], fresh[13]])
    a = np.array([c[0] for c in cycles], dtype=np.int64)
    b = np.array([c[1] for c in cycles], dtype=np.int64)
    wiring = tpk.wire_copy_pairs(n, a, b)
    got = np.arange(cols * n, dtype=np.int64)
    got[wiring.cells] = wiring.succ
    perm = jpk.apply_copy_cycles(jpk.identity_permutation(cols, n), cycles)
    assert np.array_equal(got, (perm[:, :, 0] * n + perm[:, :, 1]).ravel())
    with pytest.raises(ValueError):  # (3, 1) and (3, 5) are both shared
        tpk.wire_copy_pairs(n, np.concatenate([a, [[3, 1]]]),
                            np.concatenate([b, [[3, 5]]]))


def test_block_rows_device_equals_the_poseidon2_circuit_trace():
    """`_block_rows_device` (the RAM and narrow sponge tiles' row expansion,
    tensor code on the field ops) against the JAX package's exact host
    trace of the Poseidon2 circuit, block by block."""
    rng = np.random.default_rng(5)
    inputs = rng.integers(0, P, size=(8, 12), dtype=np.uint64)
    inputs[0] = P - 1
    inputs[1] = 0
    got = tgl.to_u64(trc._block_rows_device(tgl.from_u64(inputs, "cpu")))
    jir = jp2c.poseidon2_ir(8)
    want = convert.pairs_to_u64(*[np.asarray(a) for a in (
        lambda w: (w.lo, w.hi))(jp2c.poseidon2_witness(
            jir, [[int(v) for v in row] for row in inputs]))])
    assert got.shape == (8, 32, 12)
    assert np.array_equal(got.reshape(8 * 32, 12), want.T)


def _witness_cap_check(name, streams):
    """The port's witness of the golden instance, committed as the prover
    commits it (rate 2, cap 4), has the golden proof's witness cap."""
    tmod = MODS[name][0]
    geo = GEO_OF[name](CAP[name])
    art = _port_artifacts(name, streams, CAP[name])
    ir = _ir(tmod, geo)
    W = _witness(name, tmod, ir, geo, art, device="cpu")
    assert tuple(W.shape) == (ir.num_witness, geo.n)
    _coeffs, _lde, tree = tpk._commit_cols_with_coeffs(W, TCFG.rate,
                                                       TCFG.cap_size)
    want = np.asarray(_golden_proof(name).witness_cap,
                      dtype=object).astype(np.uint64)
    assert np.array_equal(tgl.to_u64(tree.cap), want.reshape(TCFG.cap_size,
                                                             4))


@pytest.mark.parametrize("name", ("ram", "events"))
def test_witness_commits_to_the_golden_witness_cap(name, streams):
    _witness_cap_check(name, streams)


@pytest.mark.slow
@pytest.mark.parametrize("name", ("storage", "demux"))
def test_wide_witness_commits_to_the_golden_witness_cap(name, streams):
    """As above for the two widest circuits, whose commitment takes 15-25 s
    through the plain versions on the CPU."""
    _witness_cap_check(name, streams)


def test_ram_vk_equals_golden_and_verifier_on_the_golden_proof():
    """The RAM setup at the golden geometry has the golden VK; the port's
    verifier accepts the golden proof and returns False, never raises, on a
    tampered public input and a tampered OOD value."""
    with tly.engine_override(TCFG):
        sd, geo = tly.ram_setup_data(CAP["ram"], device="cpu")
    vk = [int(v) for v in _load("ram_log8_vk.json")]
    assert sd.vk == vk
    proof = _golden_proof("ram")
    assert tpk.verify(sd.ir, vk, proof, TCFG, device="cpu", strict=True)
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    c0, c1 = bad.ood_witness[5]
    bad.ood_witness[5] = ((c0 + 1) % P, c1)
    assert tpk.verify(sd.ir, vk, bad, TCFG, device="cpu") is False


# ---------------------------------------------------------------------------
# slow: JAX queue chains and witnesses, whole setups and proofs
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_decomposers_equal_field_by_field(name, streams):
    """Every instance and the challenges of each decomposer, at the golden
    capacity and at one that splits the stream into several instances."""
    for capacity in (CAP[name], 4 if name != "storage" else 21):
        got = _port_artifacts(name, streams, capacity)
        want = _jax_artifacts(name, streams, capacity)
        assert _ints(got.instances) == _ints(want.instances)
        if name != "demux":
            assert _ints(got.challenges) == _ints(want.challenges)
    if name != "storage":  # the block's 21 storage queries are one cell
        assert len(got.instances) >= 2


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_witness_equal_bit_for_bit(name, streams):
    tmod, jmod = MODS[name]
    geo = GEO_OF[name](CAP[name])
    jgeo = _jgeo(name, geo)
    tW = _witness(name, tmod, _ir(tmod, geo), geo,
                  _port_artifacts(name, streams, CAP[name]), device="cpu")
    jW = _witness(name, jmod, _ir(jmod, jgeo), jgeo,
                  _jax_artifacts(name, streams, CAP[name]))
    want = convert.pairs_to_u64(np.asarray(jW.lo), np.asarray(jW.hi))
    assert np.array_equal(tgl.to_u64(tW), want)


@pytest.mark.slow
def test_block_rows_device_equals_the_jax_function():
    from zkevm_harness_tpu.ops import goldilocks as jgl
    rng = np.random.default_rng(6)
    inputs = rng.integers(0, P, size=(5, 12), dtype=np.uint64)
    got = tgl.to_u64(trc._block_rows_device(tgl.from_u64(inputs, "cpu")))
    assert np.array_equal(got, jgl.to_u64(jrc._block_rows_device(
        jgl.from_u64(inputs))))


def _prove_typed(name, streams):
    art = _port_artifacts(name, streams, CAP[name])
    inst, ch, c = art.instances[0], getattr(art, "challenges", None), CAP[name]
    if name == "ram":
        proof = tly.prove_ram_instance(inst, ch, c, device="cpu")
        ok = tly.verify_ram_instance(inst, ch, c, proof, device="cpu")
        sd = tly.ram_setup_data(c, device="cpu")[0]
    elif name == "events":
        proof = tly.prove_events_instance(inst, ch, c, device="cpu")
        ok = tly.verify_events_instance(inst, ch, c, proof, device="cpu")
        sd = tly.events_setup_data(c, device="cpu")[0]
    elif name == "storage":
        proof = tly.prove_storage_instance(inst, ch, c, device="cpu")
        ok = tly.verify_storage_instance(inst, ch, c, proof, device="cpu")
        sd = tly.storage_setup_data(c, device="cpu")[0]
    else:
        proof = tly.prove_demux_instance(inst, c, device="cpu")
        ok = tly.verify_demux_instance(inst, c, proof, device="cpu")
        sd = tly.demux_setup_data(c, device="cpu")[0]
    return sd, proof, ok


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_typed_prove_equals_the_golden_vk_and_proof(name, streams):
    """prove_*_instance / verify_*_instance at the golden geometry: the VK
    and the proof are the JAX package's, value for value; the JAX verifier
    accepts the port's proof."""
    with tly.engine_override(TCFG):
        sd, proof, ok = _prove_typed(name, streams)
    assert ok
    assert sd.vk == [int(v) for v in _load(f"{name}_log8_vk.json")]
    got = json.loads(json.dumps(tserde.proof_to_json(proof)))
    assert got == _load(f"{name}_log8_proof.json")
    jmod = MODS[name][1]
    jgeo = _jgeo(name, GEO_OF[name](CAP[name]))
    jproof = convert.proof_to_package(proof, jserde.default_registry())
    assert jpk.verify(_ir(jmod, jgeo), sd.vk, jproof, JCFG)


@pytest.mark.slow
@pytest.mark.parametrize("name", ("events", "storage", "demux"))
def test_port_verifier_on_the_golden_proof(name):
    geo = GEO_OF[name](CAP[name])
    ir = _ir(MODS[name][0], geo)
    vk = [int(v) for v in _load(f"{name}_log8_vk.json")]
    proof = _golden_proof(name)
    assert tpk.verify(ir, vk, proof, TCFG, device="cpu", strict=True)
    bad = copy.deepcopy(proof)
    c0, c1 = bad.ood_witness[7]
    bad.ood_witness[7] = ((c0 + 1) % P, c1)
    assert tpk.verify(ir, vk, bad, TCFG, device="cpu") is False
