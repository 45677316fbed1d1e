"""The port's precompile hash circuits — keccak round function (type 5),
SHA-256 round function (type 6) and L1-messages hasher (type 13) — on the
small hash block of `golden.py`, held against the JAX package and the
committed golden artifacts (`tools/gen_hash_golden.py`), bit for bit
(tolerance 0). The block's MainVM artifacts are held against the JAX
package's too.

Tier-1 tests stay cheap: the JAX side is host Python and numpy (VM trace,
round decompositions, IRs, constant rows, gate values on random rows,
witnesses) or the committed artifacts (the golden proofs' public inputs and
witness caps). The JAX decomposers (whose Poseidon2 hash XLA compiles for
5-20 s a call), the setups of the wide circuits and the whole proofs are
`slow`.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.circuits import keccak_circuit as jkc
from zkevm_harness_tpu.circuits import linear_hasher_circuit as jlh
from zkevm_harness_tpu.circuits import main_vm_circuit as jmvc
from zkevm_harness_tpu.circuits import sha256_circuit as jsc
from zkevm_harness_tpu.circuits.types import testing_geometry as jgeometry
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu.vm import isa as jisa
from zkevm_harness_tpu.vm.environment import (DefaultPrecompilesProcessor,
                                              InMemoryEventSink,
                                              InMemoryStorage,
                                              SimpleDecommitter, SimpleMemory)
from zkevm_harness_tpu.vm.interpreter import deploy_contract as jdeploy
from zkevm_harness_tpu.vm.interpreter import run_vm as jrun_vm
from zkevm_harness_tpu.vm.state import (BlockProperties, ProvingToolset,
                                        create_vm)
from zkevm_harness_tpu.witness import linear_hasher as jwlh
from zkevm_harness_tpu.witness import main_vm as jwmv
from zkevm_harness_tpu.witness import precompile_circuits as jwpc
from zkevm_harness_tpu.witness import precompile_rounds as jwpr
from zkevm_harness_tpu.witness.tracer import WitnessTracer as JTracer
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import keccak_circuit as tkc
from zkevm_harness_tpu_torch.circuits import linear_hasher_circuit as tlh
from zkevm_harness_tpu_torch.circuits import main_vm_circuit as tmvc
from zkevm_harness_tpu_torch.circuits import sha256_circuit as tsc
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover.stark import (DeviceAlgebra,
                                                  HostExtAlgebra)
from zkevm_harness_tpu_torch.utils import serde as tserde
from zkevm_harness_tpu_torch.utils.native import keccak256
from zkevm_harness_tpu_torch.witness import linear_hasher as twlh
from zkevm_harness_tpu_torch.witness import main_vm as twmv
from zkevm_harness_tpu_torch.witness import oracle as toracle
from zkevm_harness_tpu_torch.witness import precompile_circuits as twpc
from zkevm_harness_tpu_torch.witness import precompile_rounds as twpr

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CAP = golden.HASH_CAPACITY
TCFG = tpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
JCFG = jpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
NAMES = ("keccak", "sha256", "hasher")
MODS = {"keccak": (tkc, jkc), "sha256": (tsc, jsc), "hasher": (tlh, jlh)}
GEO_OF = {"keccak": tly.keccak_geometry_for_capacity,
          "sha256": tly.sha256_geometry_for_capacity,
          "hasher": tly.hasher_geometry_for_capacity}
IR_OF = {"keccak": "keccak_ir", "sha256": "sha256_ir", "hasher": "hasher_ir"}


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _art_name(name):
    return f"{name}_log{GEO_OF[name](CAP[name]).log_n}"


def jax_trace_hash_block(rounds, call_every, callee_reps):
    """The hash block traced by the JAX package's VM, its callees deployed
    by the JAX package's `deploy_contract`."""
    prog = golden.hash_block(jisa, rounds, call_every, callee_reps)
    limit = 8 * len(prog) + 64
    tracer = JTracer(limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=jgeometry())
    for address, code in golden.hash_callees(jisa, callee_reps):
        jdeploy(tools, address, code)
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    jrun_vm(vm, prog, limit)
    assert vm.finished
    return tracer


def precompile_calls(tracer, address):
    return [d for (_, q, d, _r) in tracer.precompile_calls
            if q.address == address]


def l1_messages(tracer):
    return toracle.dedup_events(
        [q for _, q in toracle.demux_log_queue(tracer.final_log_queue())["l1"]])


@pytest.fixture(scope="module")
def tracer():
    return golden.trace_hash_block(**golden.HASH_GOLDEN)


@pytest.fixture(scope="module")
def arts(tracer):
    """The port's three decomposers on the golden hash block (CPU)."""
    return {
        "keccak": twpc.compute_keccak_circuit_artifacts(
            precompile_calls(tracer, golden.KECCAK_ADDRESS), CAP["keccak"],
            device="cpu"),
        "sha256": twpc.compute_sha256_circuit_artifacts(
            precompile_calls(tracer, golden.SHA256_ADDRESS), CAP["sha256"],
            device="cpu"),
        "hasher": twlh.compute_hasher_circuit_artifacts(
            l1_messages(tracer), CAP["hasher"], device="cpu")}


def _payload(name, mod, art, k=0):
    """Instance payload of `mod`'s package from the port's artifacts (the
    carriers of convert.py rebuild it in the JAX package's classes)."""
    if name == "hasher":
        inst = art.instances[k]
        if mod is jlh:
            inst = convert.hasher_inputs_from(inst, jlh.HasherInstanceInputs)
        return inst
    inst = art.instances[k]
    if mod in (jkc, jsc):
        inst = convert.round_function_instance_from(
            inst, jwpc.RoundFunctionInstanceWitness,
            jwpr.RoundFunctionInvocation)
    return mod.instance_inputs(inst.invocations, art.challenges, art.gammas,
                               inst.acc_in, inst.cnt_in)


def _witness(name, mod, geo, payload, **kw):
    ir = getattr(mod, IR_OF[name])(geo.log_n)
    fn = {"keccak": "keccak_witness", "sha256": "sha256_witness",
          "hasher": "hasher_witness"}[name]
    return getattr(mod, fn)(ir, geo, payload, **kw)


def _jgeo(name, geo):
    return getattr(MODS[name][1], type(geo).__name__)(geo.log_n)


# ---------------------------------------------------------------------------
# tier-1
# ---------------------------------------------------------------------------

def test_hash_block_traces_equal_and_fill_the_golden_geometries(tracer):
    jtracer = jax_trace_hash_block(**golden.HASH_GOLDEN)
    assert convert.tracer_queries(tracer) == convert.tracer_queries(jtracer)
    assert tracer.cycle_counter == 19
    assert len(precompile_calls(tracer, golden.KECCAK_ADDRESS)) == 2
    assert len(precompile_calls(tracer, golden.SHA256_ADDRESS)) == 2
    assert len(l1_messages(tracer)) == 4
    fresh = [q for _, q in tracer.decommittment_queries if q.is_fresh]
    assert (len(tracer.decommittment_queries), len(fresh)) == (2, 1)
    assert [len(w) for w in tracer.decommitted_bytecodes.values()] == [3]
    assert tly.keccak_geometry_for_capacity(CAP["keccak"]) == \
        tkc.KeccakGeometry(7)
    assert tly.sha256_geometry_for_capacity(CAP["sha256"]) == \
        tsc.Sha256Geometry(8)
    assert tly.hasher_geometry_for_capacity(CAP["hasher"]) == \
        tlh.HasherGeometry(7)


def test_round_decompositions_equal():
    """keccak256_decompose / sha256_decompose on seeded data of 0-300 bytes
    (one to three blocks per call), split at capacity 3."""
    rng = np.random.default_rng(11)
    calls = [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
             for k in (0, 1, 32, 55, 56, 64, 135, 136, 137, 300)]
    for tdec, jdec in ((twpr.keccak256_decompose, jwpr.keccak256_decompose),
                       (twpr.sha256_decompose, jwpr.sha256_decompose)):
        got, want = tdec(calls, 3), jdec(calls, 3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert len(got.instances) > 3
    dec = twpr.keccak256_decompose(calls, 3)
    assert dec.digests == [keccak256(c) for c in calls]
    dec = twpr.sha256_decompose(calls, 3)
    assert dec.digests == [hashlib.sha256(c).digest() for c in calls]


def test_round_traces_give_keccak256_and_sha256():
    """The circuits' per-round traces, chained over a three-block message,
    give keccak256 / hashlib's SHA-256, and equal the JAX package's."""
    data = bytes(range(256)) + b"hash"
    state = [0] * 25
    for block in tlh.blocks_for_data(data):
        post = list(state)
        for l in range(17):
            post[l] ^= int.from_bytes(block[8 * l:8 * l + 8], "little")
        got = tkc.keccak_round_trace(post)
        assert got == jkc.keccak_round_trace(post)
        state = got[0][tkc.NUM_ROUNDS]
    assert b"".join(v.to_bytes(8, "little") for v in state[:4]) == \
        keccak256(data)
    from zkevm_harness_tpu_torch.circuits import decommitter_circuit as tdc
    h = list(tdc._IV)
    words = [int.from_bytes(data[i:i + 32], "big")
             for i in range(0, 256, 32)]
    for block in tdc.blocks_for_bytecode(words):
        got = tsc.sha256_round_trace(h, block)
        assert got == jsc.sha256_round_trace(h, block)
        h = got[2]
    assert b"".join(x.to_bytes(4, "big") for x in h) == \
        hashlib.sha256(data[:256]).digest()


@pytest.mark.parametrize("name", NAMES)
def test_ir_metadata_and_const_rows_equal(name):
    tmod, jmod = MODS[name]
    geo = GEO_OF[name](CAP[name])
    jgeo = _jgeo(name, geo)
    tir = getattr(tmod, IR_OF[name])(geo.log_n)
    jir = getattr(jmod, IR_OF[name])(geo.log_n)
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "lookup_sets", "lookup_tables", "gate_part_degrees"):
        assert getattr(tir, field) == getattr(jir, field), field
    assert tir.gate_part_degrees is None  # the unstratified quotient
    want = np.asarray(jmod._const_rows(jgeo), dtype=object).astype(np.uint64)
    assert np.array_equal(tmod._const_rows(geo), want)


def gate_values_equal(tir, jir, rows=2, seed=0):
    """The port's gate list on the device algebra (stacked, over `rows`
    random rows at once) equals the JAX package's gate list on the host
    algebra, row by row, value for value and in order."""
    rng = np.random.default_rng(seed)
    W = rng.integers(0, P, size=(tir.num_witness, rows), dtype=np.uint64)
    C = rng.integers(0, P, size=(tir.num_const, rows), dtype=np.uint64)
    Wt, Ct = tgl.from_u64(W, "cpu"), tgl.from_u64(C, "cpu")
    dev = tir.eval_gates(DeviceAlgebra(), list(Wt.unbind(0)),
                         list(torch.roll(Wt, -1, 1).unbind(0)),
                         list(Ct.unbind(0)))
    assert len(dev) == tir.num_gate_constraints == jir.num_gate_constraints
    got = np.stack([tgl.to_u64(v.expand(rows)) for v in dev])
    for r in range(rows):
        w = [(int(W[i, r]), 0) for i in range(tir.num_witness)]
        wn = [(int(W[i, (r + 1) % rows]), 0) for i in range(tir.num_witness)]
        c = [(int(C[i, r]), 0) for i in range(tir.num_const)]
        want = jir.eval_gates(HostExtAlgebra(), w, wn, c)
        assert [v[0] for v in want] == [int(v) for v in got[:, r]]
        assert tir.eval_gates(HostExtAlgebra(), w, wn, c) == want


@pytest.mark.parametrize("name", NAMES)
def test_gate_values_equal_on_random_rows(name):
    """Random (non-boolean) rows exercise every constraint as a
    polynomial: the stacked device evaluation and the host evaluation of
    the port give the JAX package's values, in its order."""
    tmod, jmod = MODS[name]
    gate_values_equal(getattr(tmod, IR_OF[name])(5 if name != "sha256"
                                                 else 7),
                      getattr(jmod, IR_OF[name])(5 if name != "sha256"
                                                 else 7))


@pytest.mark.parametrize("name", NAMES)
def test_witness_equal_bit_for_bit(name, arts):
    """The port's witness of the golden instance equals the JAX package's
    witness of the same payload (carried across by convert.py)."""
    tmod, jmod = MODS[name]
    geo = GEO_OF[name](CAP[name])
    tW = _witness(name, tmod, geo, _payload(name, tmod, arts[name]),
                  device="cpu")
    jW = _witness(name, jmod, _jgeo(name, geo),
                  _payload(name, jmod, arts[name]))
    want = convert.pairs_to_u64(np.asarray(jW.lo), np.asarray(jW.hi))
    assert np.array_equal(tgl.to_u64(tW), want)


@pytest.mark.parametrize("name", NAMES)
def test_challenges_and_public_inputs_equal_the_golden_proof(name, arts):
    """The port's decomposer on the golden block: its instance's public
    inputs (challenges, gammas, accumulators, digest, counts) are those of
    the JAX package's golden proof, and equal the JAX package's expected
    public inputs of the carried payload."""
    tmod, jmod = MODS[name]
    geo = GEO_OF[name](CAP[name])
    art = arts[name]
    if name == "hasher":
        got = tmod.expected_public_inputs(geo, art.instances[0])
    else:
        got = tmod.instance_public_inputs(geo, art.instances[0],
                                          (art.challenges, art.gammas))
    want = convert.proof_from_json(
        _load(f"{_art_name(name)}_proof.json")).public_inputs
    assert [int(v) % P for v in got] == [int(v) for v in want]
    jpay = _payload(name, jmod, art)
    assert got == jmod.expected_public_inputs(_jgeo(name, geo), jpay)


def test_digest_and_final_accumulators_are_the_block_s(tracer, arts):
    """The hasher's digest PIs are keccak256 of the serialised L1 messages;
    the keccak and SHA-256 final accumulators lie in the last PI lanes."""
    data = b"".join(twlh.serialize_l1_message(q) for q in l1_messages(tracer))
    geo = GEO_OF["hasher"](CAP["hasher"])
    pis = tlh.expected_public_inputs(geo, arts["hasher"].instances[0])
    assert tlh.digest_bytes(pis) == keccak256(data) == arts["hasher"].digest
    for name, mod in (("keccak", tkc), ("sha256", tsc)):
        art = arts[name]
        assert art.total_invocations == 2
        pis = mod.instance_public_inputs(GEO_OF[name](CAP[name]),
                                         art.instances[0],
                                         (art.challenges, art.gammas))
        assert pis[-5:-3] == [int(x) for x in art.final_accs]
        assert pis[-1] == 2


def test_keccak_fingerprints_chain_across_instances(tracer):
    """Split at one invocation per instance, the accumulators and counts
    chain (acc_out / cnt_out of one instance are acc_in / cnt_in of the
    next) and end at the one-instance fingerprint."""
    calls = precompile_calls(tracer, golden.KECCAK_ADDRESS)
    one = twpc.compute_keccak_circuit_artifacts(calls, 4, device="cpu")
    split = twpc.compute_keccak_circuit_artifacts(calls, 1, device="cpu")
    assert (split.challenges, split.gammas) == (one.challenges, one.gammas)
    assert len(split.instances) == 2
    a, b = split.instances
    assert (a.acc_out, a.cnt_out) == (b.acc_in, b.cnt_in)
    assert b.acc_out == one.instances[0].acc_out == split.final_accs
    pay = tkc.instance_inputs(b.invocations, split.challenges, split.gammas,
                              b.acc_in, b.cnt_in)
    assert list(b.acc_out) == tkc.fingerprint(
        split.challenges, split.gammas, pay.state_pairs, b.acc_in)


def test_main_vm_artifacts_of_the_hash_block_equal(tracer):
    """The MainVM decomposition of the golden hash block (far-call frame
    switches, precompile write-backs) equals the JAX package's, and so does
    its witness, with full u256 registers (32 u8 limbs: the block's hashes
    need all 256 bits)."""
    tgeo = tly.main_vm_geometry_for_capacity(64)
    jgeo = jmvc.VmGeometry(tgeo.log_n, tgeo.limb_bits, tgeo.num_limbs)
    assert (tgeo.limb_bits, tgeo.num_limbs) == (8, 32)
    jtracer = jax_trace_hash_block(**golden.HASH_GOLDEN)
    tart = twmv.compute_main_vm_artifacts(tracer, tgeo, capacity=64,
                                          device="cpu")
    jart = jwmv.compute_main_vm_artifacts(jtracer, jgeo, capacity=64)
    assert dataclasses.asdict(tart) == dataclasses.asdict(jart)
    twmv.crosscheck_query_binding(tracer, tgeo, tart)
    tW = tmvc.main_vm_witness(tmvc.main_vm_ir(tgeo), tgeo, tart.instances[0],
                              device="cpu")
    jW = jmvc.main_vm_witness(jmvc.main_vm_ir(jgeo), jgeo, jart.instances[0])
    assert np.array_equal(tgl.to_u64(tW), convert.pairs_to_u64(
        np.asarray(jW.lo), np.asarray(jW.hi)))


def test_carriers_round_trip(arts):
    """convert.py rebuilds a payload in the other package's classes and
    back without a change."""
    inst = arts["keccak"].instances[0]
    there = convert.round_function_instance_from(
        inst, jwpc.RoundFunctionInstanceWitness, jwpr.RoundFunctionInvocation)
    assert isinstance(there.invocations[0], jwpr.RoundFunctionInvocation)
    assert convert.round_function_instance_from(there) == inst
    hi = arts["hasher"].instances[0]
    assert convert.hasher_inputs_from(
        convert.hasher_inputs_from(hi, jlh.HasherInstanceInputs)) == hi


# ---------------------------------------------------------------------------
# slow: JAX decomposers, setups and whole proofs
# ---------------------------------------------------------------------------

def _jax_artifacts(name, tracer):
    if name == "keccak":
        return jwpc.compute_keccak_circuit_artifacts(
            precompile_calls(tracer, golden.KECCAK_ADDRESS), CAP["keccak"])
    if name == "sha256":
        return jwpc.compute_sha256_circuit_artifacts(
            precompile_calls(tracer, golden.SHA256_ADDRESS), CAP["sha256"])
    return jwlh.compute_hasher_circuit_artifacts(l1_messages(tracer),
                                                 CAP["hasher"])


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_decomposers_equal_field_by_field(name, tracer, arts):
    got, want = arts[name], _jax_artifacts(name, tracer)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _prove_typed(name, art):
    c = CAP[name]
    if name == "hasher":
        inst = art.instances[0]
        proof = tly.prove_hasher_instance(inst, c, device="cpu")
        ok = tly.verify_hasher_instance(inst, c, proof, device="cpu")
        return tly.hasher_setup_data(c, device="cpu")[0], proof, ok
    inst, cg = art.instances[0], (art.challenges, art.gammas)
    prove = getattr(tly, f"prove_{name}_instance")
    verify = getattr(tly, f"verify_{name}_instance")
    proof = prove(inst, cg, c, device="cpu")
    ok = verify(inst, cg, c, proof, device="cpu")
    return getattr(tly, f"{name}_setup_data")(c, device="cpu")[0], proof, ok


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_typed_prove_equals_the_golden_vk_and_proof(name, arts):
    """prove_*_instance / verify_*_instance at the golden geometry: the VK
    and the proof are the JAX package's, value for value; the JAX verifier
    accepts the port's proof; a tampered public input or OOD value is
    refused."""
    with tly.engine_override(TCFG):
        sd, proof, ok = _prove_typed(name, arts[name])
    assert ok
    assert sd.vk == [int(v) for v in _load(f"{_art_name(name)}_vk.json")]
    got = json.loads(json.dumps(tserde.proof_to_json(proof)))
    assert got == _load(f"{_art_name(name)}_proof.json")
    jmod = MODS[name][1]
    jir = getattr(jmod, IR_OF[name])(GEO_OF[name](CAP[name]).log_n)
    jproof = convert.proof_to_package(proof, jserde.default_registry())
    assert jpk.verify(jir, sd.vk, jproof, JCFG)
    bad = convert.proof_from_json(got)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    assert tpk.verify(sd.ir, sd.vk, bad, TCFG, device="cpu") is False
    bad = convert.proof_from_json(got)
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((c0 + 1) % P, c1)
    assert tpk.verify(sd.ir, sd.vk, bad, TCFG, device="cpu") is False
