"""The port's decommitment pair — the code decommitter (type 3) and the
decommitments sorter (type 2) — on the small hash block of `golden.py`,
held against the JAX package and the committed golden artifacts
(`tools/gen_hash_golden.py`), bit for bit (tolerance 0).

Tier-1 tests stay cheap: the JAX side is host Python and numpy (IRs,
constant rows, copy cycles, gate values on random rows, the decommitter's
witness) or the committed artifacts (the golden proofs' public inputs). The
JAX decomposers and the sorter's JAX witness (whose queue chains and row
expansion XLA compiles for 15-20 s), and the whole proofs, are `slow`.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu.circuits import decommitter_circuit as jdc
from zkevm_harness_tpu.circuits import decommitts_sorter_circuit as jds
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu.witness import decommitter as jwd
from zkevm_harness_tpu.witness import sorters as jwsort
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import decommitter_circuit as tdc
from zkevm_harness_tpu_torch.circuits import decommitts_sorter_circuit as tds
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import serde as tserde
from zkevm_harness_tpu_torch.witness import decommitter as twd
from zkevm_harness_tpu_torch.witness import sorters as twsort

from .test_torch_hashes import gate_values_equal

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CAP = golden.HASH_CAPACITY
TCFG = tpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
JCFG = jpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tracer():
    return golden.trace_hash_block(**golden.HASH_GOLDEN)


def _queries(tracer):
    return [q for _, q in tracer.decommittment_queries]


def _fresh(tracer):
    return [q for q in _queries(tracer) if q.is_fresh]


@pytest.fixture(scope="module")
def dec_art(tracer):
    return twd.compute_code_decommitter_artifacts(
        _fresh(tracer), tracer.decommitted_bytecodes, device="cpu")


@pytest.fixture(scope="module")
def srt_art(tracer):
    return twsort.compute_decommitts_circuit_artifacts(
        _queries(tracer), CAP["decommitts"], device="cpu")


DEC_GEO = tly.code_decommitter_geometry_for_capacity(CAP["decommitter"])
SRT_GEO = tly.decommitts_geometry_for_capacity(CAP["decommitts"])
JDEC_GEO = jdc.DecommitterGeometry(DEC_GEO.log_n)
JSRT_GEO = jds.DecommittsGeometry(SRT_GEO.log_n, SRT_GEO.tiles_per_queue)


# ---------------------------------------------------------------------------
# tier-1
# ---------------------------------------------------------------------------

def test_geometries_are_those_of_the_golden_artifacts():
    assert DEC_GEO == tdc.DecommitterGeometry(8)
    assert SRT_GEO == tds.DecommittsGeometry(8, 1)


@pytest.mark.parametrize("tiles", (1, 2))
def test_decommitts_ir_const_rows_and_copy_wiring_equal(tiles):
    """IR metadata, constant rows and the copy permutation (from the port's
    cell pairs and from the JAX package's cycles) of the decommitments
    sorter, with one tile per strip (the golden geometry) and with two
    (the cross-tile chaining of production)."""
    geo = tds.DecommittsGeometry(8, tiles)
    jgeo = jds.DecommittsGeometry(8, tiles)
    tir, jir = tds.decommitts_ir(8, tiles), jds.decommitts_ir(8, tiles)
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "lookup_sets", "gate_part_degrees"):
        assert getattr(tir, field) == getattr(jir, field), field
    assert (tir.lookup_tables[0] == jir.lookup_tables[0]).all()
    want = np.asarray(jds._const_rows(jgeo), dtype=object).astype(np.uint64)
    assert np.array_equal(tds._const_rows(geo), want)
    n = geo.n
    wiring = tpk.wire_copy_pairs(n, *tds._copy_pairs(geo))
    got = np.arange(tir.num_witness * n, dtype=np.int64)
    got[wiring.cells] = wiring.succ
    perm = jpk.apply_copy_cycles(jpk.identity_permutation(jir.num_witness, n),
                                 jds._copy_cycles(jgeo))
    assert np.array_equal(got, (perm[:, :, 0] * n + perm[:, :, 1]).ravel())


def test_decommitter_ir_and_const_rows_equal():
    tir, jir = tdc.decommitter_ir(DEC_GEO.log_n), jdc.decommitter_ir(
        JDEC_GEO.log_n)
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "lookup_sets", "lookup_tables", "gate_part_degrees"):
        assert getattr(tir, field) == getattr(jir, field), field
    want = np.asarray(jdc._const_rows(JDEC_GEO),
                      dtype=object).astype(np.uint64)
    assert np.array_equal(tdc._const_rows(DEC_GEO), want)


@pytest.mark.parametrize("name", ("decommitter", "decommitts"))
def test_gate_values_equal_on_random_rows(name):
    if name == "decommitter":
        gate_values_equal(tdc.decommitter_ir(7), jdc.decommitter_ir(7))
    else:
        gate_values_equal(tds.decommitts_ir(8, 2), jds.decommitts_ir(8, 2))


def test_decommitter_witness_and_public_inputs(tracer, dec_art):
    """The decommitter's witness of the golden bytecode equals the JAX
    package's of the carried payload; its public inputs are the golden
    proof's, and its digest PIs are the SHA-256 inside the bytecode's
    versioned hash."""
    assert len(dec_art.instances) == 1
    inst = dec_art.instances[0]
    jinst = convert.decommitter_inputs_from(inst,
                                            jdc.DecommitterInstanceInputs)
    tW = tdc.decommitter_witness(tdc.decommitter_ir(DEC_GEO.log_n), DEC_GEO,
                                 inst, device="cpu")
    jW = jdc.decommitter_witness(jdc.decommitter_ir(JDEC_GEO.log_n),
                                 JDEC_GEO, jinst)
    assert np.array_equal(tgl.to_u64(tW), convert.pairs_to_u64(
        np.asarray(jW.lo), np.asarray(jW.hi)))
    pis = tdc.expected_public_inputs(DEC_GEO, inst)
    assert pis == jdc.expected_public_inputs(JDEC_GEO, jinst)
    want = convert.proof_from_json(
        _load(f"decommitter_log{DEC_GEO.log_n}_proof.json")).public_inputs
    assert pis == [int(v) for v in want]
    (h, words), = tracer.decommitted_bytecodes.items()
    sha = hashlib.sha256(b"".join(int(w).to_bytes(32, "big")
                                  for w in words)).digest()
    assert tdc.digest_bytes(pis) == sha
    assert dec_art.hashes == [h] == [twd.bytecode_hash(words)]
    assert sha[4:] == h.to_bytes(32, "big")[4:]


def test_decommitts_public_inputs_equal_the_golden_proof(srt_art):
    inst = srt_art.instances[0]
    assert (inst.num_items, inst.out_items) == (2, 1)
    got = tds.instance_public_inputs(SRT_GEO, inst, srt_art.challenges)
    want = convert.proof_from_json(
        _load(f"decommitts_log{SRT_GEO.log_n}_proof.json")).public_inputs
    assert [int(v) % P for v in got] == [int(v) for v in want]
    carried = convert.decommitts_instance_from(
        inst, jwsort.DecommittsCircuitInstance)
    assert got == jds.instance_public_inputs(JSRT_GEO, carried,
                                             srt_art.challenges)


def test_decommitter_snapshots_equal(tracer):
    for capacity in (2, 8):
        got = twd.compute_decommitter_circuit_snapshots(
            _fresh(tracer), tracer.decommitted_bytecodes, capacity)
        want = jwd.compute_decommitter_circuit_snapshots(
            _fresh(tracer), tracer.decommitted_bytecodes, capacity)
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]


# ---------------------------------------------------------------------------
# slow: JAX decomposers and sorter witness, whole proofs
# ---------------------------------------------------------------------------

def _ints(x):
    if isinstance(x, np.ndarray):
        return [_ints(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_ints(v) for v in x]
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return int(x)
    return x


@pytest.mark.slow
def test_decomposers_equal_field_by_field(tracer, dec_art):
    """The code decommitter's and the sorter's decomposers, the sorter at
    the golden capacity and at one request per instance (the second
    instance has a previous entry, a repeated hash and nothing to emit)."""
    want = jwd.compute_code_decommitter_artifacts(
        _fresh(tracer), tracer.decommitted_bytecodes)
    assert want.hashes == dec_art.hashes
    assert [dataclasses.asdict(i) for i in want.instances] == \
        [dataclasses.asdict(i) for i in dec_art.instances]
    for capacity in (CAP["decommitts"], 1):
        got = twsort.compute_decommitts_circuit_artifacts(
            _queries(tracer), capacity, device="cpu")
        want = jwsort.compute_decommitts_circuit_artifacts(_queries(tracer),
                                                           capacity)
        assert got.challenges == [int(v) for v in want.challenges]
        assert [{k: _ints(v) for k, v in dataclasses.asdict(i).items()}
                for i in got.instances] == \
            [{k: _ints(v) for k, v in dataclasses.asdict(i).items()}
             for i in want.instances]


@pytest.mark.slow
@pytest.mark.parametrize("capacity,k", ((8, 0), (1, 1)))
def test_decommitts_witness_equal_bit_for_bit(tracer, capacity, k):
    art = twsort.compute_decommitts_circuit_artifacts(_queries(tracer),
                                                      capacity, device="cpu")
    inst = art.instances[k]
    tW = tds.decommitts_witness(
        tds.decommitts_ir(SRT_GEO.log_n, 1), SRT_GEO,
        tds.instance_inputs(inst, art.challenges), device="cpu")
    carried = convert.decommitts_instance_from(
        inst, jwsort.DecommittsCircuitInstance)
    jW = jds.decommitts_witness(
        jds.decommitts_ir(JSRT_GEO.log_n, 1), JSRT_GEO,
        jds.instance_inputs(carried, art.challenges))
    assert np.array_equal(tgl.to_u64(tW), convert.pairs_to_u64(
        np.asarray(jW.lo), np.asarray(jW.hi)))


@pytest.mark.slow
@pytest.mark.parametrize("name", ("decommitter", "decommitts"))
def test_typed_prove_equals_the_golden_vk_and_proof(name, dec_art, srt_art):
    """prove_*_instance / verify_*_instance at the golden geometry: VK and
    proof are the JAX package's, value for value; the JAX verifier accepts
    the port's proof; tampered copies are refused."""
    with tly.engine_override(TCFG):
        if name == "decommitter":
            inst, c = dec_art.instances[0], CAP["decommitter"]
            proof = tly.prove_code_decommitter_instance(inst, c,
                                                        device="cpu")
            assert tly.verify_code_decommitter_instance(inst, c, proof,
                                                        device="cpu")
            sd, geo = tly.code_decommitter_setup_data(c, device="cpu")
            jir = jdc.decommitter_ir(geo.log_n)
        else:
            inst, c = srt_art.instances[0], CAP["decommitts"]
            ch = srt_art.challenges
            proof = tly.prove_decommitts_instance(inst, ch, c, device="cpu")
            assert tly.verify_decommitts_instance(inst, ch, c, proof,
                                                  device="cpu")
            sd, geo = tly.decommitts_setup_data(c, device="cpu")
            jir = jds.decommitts_ir(geo.log_n, geo.tiles_per_queue)
    stem = f"{name}_log{geo.log_n}"
    assert sd.vk == [int(v) for v in _load(f"{stem}_vk.json")]
    got = json.loads(json.dumps(tserde.proof_to_json(proof)))
    assert got == _load(f"{stem}_proof.json")
    jproof = convert.proof_to_package(proof, jserde.default_registry())
    assert jpk.verify(jir, sd.vk, jproof, JCFG)
    bad = convert.proof_from_json(got)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    assert tpk.verify(sd.ir, sd.vk, bad, TCFG, device="cpu") is False
    bad = convert.proof_from_json(got)
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((c0 + 1) % P, c1)
    assert tpk.verify(sd.ir, sd.vk, bad, TCFG, device="cpu") is False
