"""The port's BN254-hashed compression for the wrapper and its SNARK tiers —
the `backend` branches of `prover/plonkish.py` and `prover/fri.py`, the
for-wrapper surface of `prover/layers.py`, `utils/plonk_builder.py`, the
"binding" tier of `utils/snark_wrapper.py`, `utils/snark_fri_verifier.py`
(the "full" tier) and `full_chain.py`'s `for_wrapper` — held against the
JAX package's committed golden artifacts (`tools/gen_fw_golden.py`), value
for value (integers, tolerance 0).

Tier-1 tests start no JAX proof: the JAX side is the committed artifacts
(the `queue_ir(5)` stand-in's for-wrapper proof, mode 1 for the wrapper
over the golden tower's scheduler, the binding SNARK over mode 1's VK, the
digests of the "full" statement over the stand-in proof). Proving mode 1 to
equal bytes, the "full" PLONK prove and the JAX verifier on a proof made
on the card are `slow`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.circuits import queue_circuit as tqc
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.ops import ntt as tnt
from zkevm_harness_tpu_torch.prover import compression as tcp
from zkevm_harness_tpu_torch.prover import hash_backend as thb
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import snark_fri_verifier as tsfv
from zkevm_harness_tpu_torch.utils import snark_wrapper as tsw
from zkevm_harness_tpu_torch.utils.bn254 import R as FR

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
STANDIN = tpk.PlonkishConfig(rate=2, cap_size=4, num_queries=2,
                             final_fri_size=8)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _proof_json(proof):
    return convert.json_roundtrip(convert.proof_to_json(proof))


GOLDEN_PI = _load("tower_golden_summary.json")["scheduler_pi"]


# -- the stand-in for-wrapper proof -------------------------------------------

@pytest.fixture(scope="module")
def standin():
    """The stand-in (`queue_ir(5)`, witness [[1..8]]) proved for the
    wrapper by the port on the CPU: its Fr VK is the cap of the setup
    tree, its trees and transcript Poseidon2-BN254."""
    ir = tqc.queue_ir(5)
    setup = tqc.queue_setup(ir, STANDIN, device="cpu")
    W = tqc.queue_witness(ir, [[i + 1 for i in range(8)]], device="cpu")
    backend = thb.Bn254Backend("cpu")
    cols = tgl.concatenate(
        [setup.const_cols, setup.sigma_cols, setup.table_cols], axis=0)
    tree = backend.commit_rows(tnt.coset_lde(cols, STANDIN.rate),
                               STANDIN.cap_size)
    proof = tpk.prove(ir, setup, W, STANDIN, backend=backend,
                      backend_setup=(tree.cap, tree), device="cpu")
    return ir, tree.cap, proof, backend


def test_standin_vk_and_proof_equal_the_golden_bytes(standin):
    _ir, vk, proof, _backend = standin
    assert vk == _load("fw_standin_vk.json")
    assert all(0 <= v < FR for v in vk) and len(vk) == STANDIN.cap_size
    assert _proof_json(proof) == _load("fw_standin_proof.json")
    assert np.asarray(proof.witness_cap, dtype=object).ndim == 1
    assert isinstance(proof.fri.query_positions, list)


def _tampered(proof, what):
    if what == "public_input":
        pis = list(proof.public_inputs)
        pis[0] = (int(pis[0]) + 1) % P
        return dataclasses.replace(proof, public_inputs=pis)
    if what == "cap":
        cap = np.asarray(proof.witness_cap, dtype=object).copy()
        cap[0] = int(cap[0]) + 1
        return dataclasses.replace(proof, witness_cap=cap)
    if what == "ood":
        ood = list(proof.ood_witness)
        ood[0] = ((int(ood[0][0]) + 1) % P, ood[0][1])
        return dataclasses.replace(proof, ood_witness=ood)
    idx = sorted(proof.openings["witness"].keys())[0]
    openings = {k: dict(v) for k, v in proof.openings.items()}
    row = list(openings["witness"][idx])
    row[0] = (int(row[0]) + 1) % P
    openings["witness"][idx] = row
    return dataclasses.replace(proof, openings=openings)


TAMPERS = ("public_input", "cap", "ood", "opening")


def test_standin_verifies_and_refuses_tampered_copies(standin):
    ir, vk, proof, backend = standin
    assert tpk.verify(ir, vk, proof, STANDIN, device="cpu", backend=backend)
    golden = convert.proof_from_json(_load("fw_standin_proof.json"))
    assert tpk.verify(ir, _load("fw_standin_vk.json"), golden, STANDIN,
                      device="cpu", backend=backend)
    for what in TAMPERS:
        assert not tpk.verify(ir, vk, _tampered(proof, what), STANDIN,
                              device="cpu", backend=backend), what
    assert not tpk.verify(ir, [v + 1 for v in vk], proof, STANDIN,
                          device="cpu", backend=backend)


def test_for_wrapper_engine_config_is_the_production_one():
    assert tly.for_wrapper_engine_config(1) == tpk.PlonkishConfig(
        rate=2, cap_size=16, num_queries=40, final_fri_size=32)
    assert [tly.for_wrapper_engine_config(m).rate for m in range(1, 6)] == \
        [2, 512, 1024, 2048, 4096]


# -- mode 1 for the wrapper over the golden scheduler ----------------------------

def test_golden_mode1_binds_the_golden_scheduler():
    """The JAX package's mode 1 for the wrapper: Fr caps, public inputs
    the golden scheduler's VK and public inputs."""
    proof = convert.proof_from_json(_load("fw_mode1_proof.json"))
    vk = _load("fw_mode1_vk.json")
    assert len(vk) == 16 and all(0 <= v < FR for v in vk)
    sched = convert.proof_from_json(_load(
        "tower_golden_scheduler_proof.json"))
    assert [int(v) for v in proof.public_inputs] == \
        _load("tower_golden_scheduler_vk.json") + \
        [int(v) for v in sched.public_inputs]
    assert len(proof.witness_cap) == 16
    assert len(proof.fri.query_positions) == 40


@pytest.mark.slow
def test_mode1_for_wrapper_over_the_golden_scheduler_proves_the_golden_bytes():
    """CompressionChain(wrapper_mode=1) at `for_wrapper_engine_config(1)`
    over the golden tower's scheduler proof: VK and proof equal the JAX
    package's; a changed inner public input is refused."""
    from tests.test_torch_wrap import _golden_scheduler
    ir, cfg, vk = _golden_scheduler()
    sched = convert.proof_from_json(_load(
        "tower_golden_scheduler_proof.json"))
    chain = tly.CompressionChain(ir, cfg, vk, wrapper_mode=1, device="cpu")
    out = tcp.wrap_proof(sched, GOLDEN_PI, tcp.WrapperConfig(1),
                         chain.prove_fn, chain.verify_fn)
    assert out["final_vk"] == _load("fw_mode1_vk.json")
    assert _proof_json(out["final_proof"]) == _load("fw_mode1_proof.json")
    assert chain.stats[1]["for_wrapper"] is True
    bad = dataclasses.replace(out["final_proof"], public_inputs=[
        (int(out["final_proof"].public_inputs[len(vk)]) + 1) % P
        if i == len(vk) else int(v)
        for i, v in enumerate(out["final_proof"].public_inputs)])
    assert not chain.verify_fn(1, bad, out["final_vk"])
    _fw_ir, fw_cfg, fw_vk = chain.final_shape(1)
    assert fw_cfg == tly.for_wrapper_engine_config(1)
    assert fw_vk == out["final_vk"]


# -- the "binding" SNARK tier ----------------------------------------------------

@pytest.fixture(scope="module")
def binding():
    fw_vk = _load("fw_mode1_vk.json")
    setup, proof = tsw.wrap_with_binding(fw_vk, GOLDEN_PI)
    return fw_vk, setup, proof


def test_binding_snark_equals_the_golden_bytes(binding):
    fw_vk, setup, proof = binding
    assert setup.circuit.num_gates == 5676 and setup.vk.n == 1 << 13
    assert convert.json_roundtrip(convert.plonk_vk_to_json(setup.vk)) == \
        _load("fw_binding_snark_vk.json")
    assert convert.json_roundtrip(convert.plonk_proof_to_json(proof)) == \
        _load("fw_binding_snark_proof.json")
    assert tsw.verify_binding_proof(setup.vk, proof, expected_fw_vk=fw_vk,
                                    expected_scheduler_pi=GOLDEN_PI)
    k = len(fw_vk)
    assert proof.public_inputs[k + 4] == \
        tcp.compress_stark_pi_to_snark_pi(GOLDEN_PI)


@pytest.mark.parametrize("what", ("fw_vk", "scheduler_pi", "binding",
                                  "evaluation"))
def test_binding_snark_refuses_a_tampered_proof(binding, what):
    fw_vk, setup, proof = binding
    p = dataclasses.replace(proof, evals=dict(proof.evals),
                            public_inputs=list(proof.public_inputs))
    want_vk, want_pi = fw_vk, GOLDEN_PI
    if what == "fw_vk":
        want_vk = [fw_vk[0] + 1] + fw_vk[1:]
    elif what == "scheduler_pi":
        want_pi = [GOLDEN_PI[0] + 1] + GOLDEN_PI[1:]
    elif what == "binding":
        p.public_inputs[-1] = (p.public_inputs[-1] + 1) % FR
    else:
        p.evals["a"] = (p.evals["a"] + 1) % FR
    assert tsw.verify_binding_proof(setup.vk, p, expected_fw_vk=want_vk,
                                    expected_scheduler_pi=want_pi) is False


# -- the "full" SNARK tier: the in-SNARK verifier's statement --------------------

@pytest.fixture(scope="module")
def full_statement():
    ir = tqc.queue_ir(5)
    vk = _load("fw_standin_vk.json")
    proof = convert.proof_from_json(_load("fw_standin_proof.json"))
    return ir, vk, proof


def test_full_statement_equals_jax_and_gate_checks(full_statement):
    """The statement over the JAX package's stand-in proof: selectors,
    wiring, public gates and assignment equal the JAX package's (SHA-256
    digests); every gate holds; its public inputs are [fw VK, the inner
    public inputs, the packed SNARK input]."""
    ir, vk, proof = full_statement
    stats = tsfv.gate_check_fw(ir, STANDIN, vk, proof)
    b, lay, _circ = tsfv.build_cached(ir, STANDIN, len(vk))
    wires, pis = b.fill(tsfv.fill_fw_assignments(lay, ir, STANDIN, vk,
                                                 proof))
    want = _load("fw_full_statement.json")
    got = convert.plonk_statement_digests(b, wires, pis)
    assert got == {k: v for k, v in want.items() if k != "public_inputs"}
    assert [str(v) for v in pis] == want["public_inputs"]
    assert stats["n_gates"] == want["n_gates"] > 100_000
    k, m = len(vk), len(proof.public_inputs)
    assert pis[:k] == vk
    assert pis[k:k + m] == [int(v) % P for v in proof.public_inputs]
    assert pis[k + m] == tcp.compress_stark_pi_to_snark_pi(
        proof.public_inputs[-4:])


@pytest.mark.parametrize("what", TAMPERS)
def test_full_statement_refuses_a_tampered_proof(full_statement, what):
    ir, vk, proof = full_statement
    with pytest.raises(AssertionError):
        tsfv.gate_check_fw(ir, STANDIN, vk, _tampered(proof, what))


def test_sponge_gadget_replays_the_transcript():
    """The in-circuit sponge draws the port's Bn254Transcript's
    challenges and query bits."""
    from zkevm_harness_tpu_torch.utils import plonk_builder as pb
    b = pb.PlonkBuilder()
    g = tsfv.G(b)
    sp = tsfv.SpongeGadget(g)
    fr_ins = [b.input() for _ in range(3)]
    gl_ins = [g.input_gl() for _ in range(5)]
    sp.absorb_vars(fr_ins)
    sp.absorb_gl(gl_ins)
    (c0, c1), _ = sp.challenge_ext()
    qbits = sp.query_bits(5)
    for v in [c0.var, c1.var] + qbits:
        b.mark_public(v)
    fr_vals = [123456789, 987654321, FR - 5]
    gl_vals = [1, 2, 3, 0xFFFFFFFF00000000, 42]
    asg = dict(zip(fr_ins, fr_vals))
    asg.update({v.var: x for v, x in zip(gl_ins, gl_vals)})
    _wires, pis = b.fill(asg)
    tr = thb.Bn254Transcript(device="cpu")
    tr.absorb_fr(fr_vals)
    tr.absorb_ints(gl_vals)
    assert [int(x) % P for x in pis[:2]] == list(tr.challenge_ext_ints())
    assert sum(int(pis[2 + k]) << k for k in range(5)) == \
        tr.query_indices(1, 32)[0]


@pytest.mark.slow
def test_full_plonk_prove_of_the_standin_statement(full_statement):
    """The "full" tier end to end at the stand-in: the port's PLONK proof
    of the in-SNARK verifier (388,452 gates, a 2^19 domain; tens of
    minutes of host Python) verifies with the expected VK and inputs."""
    ir, vk, proof = full_statement
    setup, snark, _lay = tsfv.wrap_fw_proof(ir, STANDIN, vk, proof)
    assert setup.vk.n == 1 << 19
    assert tsfv.verify_fw_wrapped(setup.vk, snark, expected_fw_vk=vk,
                                  expected_inner_pis=proof.public_inputs)
    assert not tsfv.verify_fw_wrapped(
        setup.vk, snark, expected_fw_vk=[vk[0] + 1] + vk[1:],
        expected_inner_pis=proof.public_inputs)


# -- the JAX verifier on the card's production proof -----------------------------

@pytest.mark.slow
def test_jax_verifier_accepts_the_cards_production_for_wrapper_proof():
    """Mode 1 for the wrapper made on the card at production parameters
    (chip_smoke.py phase `tower`: the whole block's three-slot scheduler,
    `for_wrapper_engine_config(1)`), judged by the JAX package's
    `verify_compression_for_wrapper_proof` over the JAX package's own
    synthesis of that scheduler and of its verifier circuit; a changed
    public input is refused. The VK is the card's: the JAX package's setup
    would hash a 2^18-leaf tree in host Python (about an hour), so its
    for-wrapper setup is seeded with the circuit it synthesized and the
    card's Fr cap."""
    from zkevm_harness_tpu.circuits import verifier_circuit as jvc
    from zkevm_harness_tpu.prover import hash_backend as jhb
    from zkevm_harness_tpu.prover import layers as jly
    from zkevm_harness_tpu.utils import serde as jserde
    summary = _load("fw_production_summary.json")
    vk = _load("fw_production_vk.json")
    sched_ir, sched_cfg = _production_scheduler(summary)
    assert [sched_ir.log_n, sched_ir.num_witness] == \
        summary["scheduler_shape"]
    fw_cfg = jly.for_wrapper_engine_config(1)
    b, lay = jvc.synthesize_verifier(sched_ir, sched_cfg, slots=8)
    built = b.finalize()
    key = ("compression_fw", 1, sched_ir.log_n, sched_ir.num_witness,
           sched_cfg.rate, sched_cfg.cap_size, sched_cfg.num_queries,
           sched_cfg.final_fri_size, fw_cfg.rate, fw_cfg.num_queries)
    jly._SETUP_CACHE[key] = jly.ForWrapperSetup(
        sd=jly.SetupData(ir=built.ir, setup=None, vk=vk, config=fw_cfg),
        builder=b, layout=lay, backend=jhb.Bn254Backend(), vk_fr=vk,
        setup_tree=None)
    try:
        jproof = jserde.proof_from_json(_load("fw_production_proof.json"),
                                        jserde.default_registry())
        args = (1, sched_ir, sched_cfg)
        assert jly.verify_compression_for_wrapper_proof(
            *args, jproof, vk, expected_inner_vk=summary["scheduler_vk"])
        k = len(summary["scheduler_vk"])
        bad = dataclasses.replace(jproof, public_inputs=[
            (int(v) + 1) % P if i == k else int(v)
            for i, v in enumerate(jproof.public_inputs)])
        assert not jly.verify_compression_for_wrapper_proof(
            *args, bad, vk, expected_inner_vk=summary["scheduler_vk"])
    finally:
        del jly._SETUP_CACHE[key]


def _production_scheduler(summary):
    """The JAX package's synthesis of the card's production scheduler: the
    leaves (arity 1) and nodes of the RAM permutation (8) and ecrecover
    (7) at `GeometryConfig()`, and the blob slot of the 16-element fold
    circuit, at the configs the card's run recorded."""
    from zkevm_harness_tpu.circuits import eip4844_circuit as je4
    from zkevm_harness_tpu.circuits import ffarith as jff
    from zkevm_harness_tpu.circuits import leaf_circuit as jlc
    from zkevm_harness_tpu.circuits import node_circuit as jnc
    from zkevm_harness_tpu.circuits import ram_permutation_circuit as jrc
    from zkevm_harness_tpu.circuits import scheduler_circuit as jsc
    from zkevm_harness_tpu.circuits.types import GeometryConfig
    from zkevm_harness_tpu.prover import layers as jly
    cfg = jly.pk.PlonkishConfig(**summary["scheduler_config"])
    blob_cfg = jly.pk.PlonkishConfig(**summary["blob_config"])

    def layout_ir(layout):
        ir = jff.ff_ir(layout.params, layout.log_n, layout.num_rows,
                       bind_c=layout.bind_c)
        return dataclasses.replace(ir, public_input_cells=layout.pi_cells)

    geo = jly.ram_geometry_for_capacity(
        GeometryConfig().cycles_per_ram_permutation)
    base = {8: jrc.ram_ir(geo.log_n, geo.tiles_per_queue),
            7: layout_ir(jly._ecrecover_program().layout)}
    nodes = []
    for t in sorted(summary["spot_types"]):
        leaf_b, _ = jlc.synthesize_leaf(base[t], cfg, arity=1,
                                        base_circuit_type=t)
        node_b, _ = jnc.synthesize_node(leaf_b.finalize().ir, cfg, arity=1)
        nodes.append((node_b.finalize().ir, cfg))
    blob = layout_ir(je4.build_eip4844_program(
        summary["kzg_domain"], limb_bits=8).layout)
    sb, _ = jsc.synthesize_scheduler_multi(
        nodes, type_ids=tuple(sorted(summary["spot_types"])),
        aux_len=len(summary["aux_values"]),
        blob_children=[(blob, blob_cfg)])
    return sb.finalize().ir, cfg
