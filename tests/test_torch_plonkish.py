"""The port's slice as a whole: setup -> witness -> prove -> verify on the
golden shape, held against the committed golden artifacts and the JAX
verifier. No fresh JAX proof is made here."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.circuits import flagship as jfl
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.circuits import flagship as tfl
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import serde as tserde

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
KW = dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8)
TCFG = tpk.PlonkishConfig(**KW)
JCFG = jpk.PlonkishConfig(**KW)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden_vk():
    return [int(v) for v in _load("flagship_log6_vk.json")]


@pytest.fixture(scope="module")
def port_run():
    ir = tfl.flagship_ir(log_n=6, width=8)
    setup = tfl.flagship_setup(ir, TCFG, device="cpu")
    witness = tfl.flagship_witness(ir, seed=42, device="cpu")
    proof = tpk.prove(ir, setup, witness, TCFG, device="cpu")
    return ir, setup, proof


def test_setup_vk_equals_golden(port_run, golden_vk):
    _ir, setup, _proof = port_run
    assert setup.vk() == golden_vk


def test_proof_equals_golden_json(port_run):
    _ir, _setup, proof = port_run
    got = json.loads(json.dumps(tserde.proof_to_json(proof)))
    assert got == _load("flagship_log6_proof.json")


def test_port_verifies_its_own_proof(port_run):
    ir, setup, proof = port_run
    assert tpk.verify(ir, setup.vk(), proof, TCFG, device="cpu", strict=True)


def test_port_verifies_the_golden_proof(port_run, golden_vk):
    ir = port_run[0]
    proof = convert.proof_from_json(_load("flagship_log6_proof.json"))
    assert isinstance(proof, tpk.PlonkishProof)
    assert tpk.verify(ir, golden_vk, proof, TCFG, device="cpu", strict=True)


def _bump_public_input(p):
    p.public_inputs[0] = (p.public_inputs[0] + 1) % P


def _bump_ood(p):
    c0, c1 = p.ood_witness[3]
    p.ood_witness[3] = ((c0 + 1) % P, c1)


def _bump_opening(p):
    idx = sorted(p.openings["witness"].keys())[0]
    p.openings["witness"][idx][0] = (p.openings["witness"][idx][0] + 1) % P


def _drop_ood(p):
    p.ood_sigma.pop()


def _truncate_path(p):
    idx = sorted(p.paths["stage2"].keys())[0]
    p.paths["stage2"][idx] = p.paths["stage2"][idx][:-1]


@pytest.mark.parametrize("mutate", [_bump_public_input, _bump_ood,
                                    _bump_opening, _drop_ood, _truncate_path],
                         ids=lambda f: f.__name__.strip("_"))
def test_tampered_golden_proof_gives_false(port_run, golden_vk, mutate):
    ir = port_run[0]
    proof = convert.proof_from_json(_load("flagship_log6_proof.json"))
    mutate(proof)
    assert tpk.verify(ir, golden_vk, proof, TCFG, device="cpu") is False


def test_jax_verifier_accepts_the_port_proof(port_run, golden_vk):
    _ir, _setup, proof = port_run
    as_jax = convert.proof_to_package(proof, jserde.default_registry())
    assert isinstance(as_jax, jpk.PlonkishProof)
    jir = jfl.flagship_ir(log_n=6, width=8)
    assert jpk.verify(jir, golden_vk, as_jax, JCFG)


def test_setup_from_jax_arrays_equals_own_setup(port_run):
    _ir, setup, _proof = port_run
    jir = jfl.flagship_ir(log_n=6, width=8)
    js = jfl.flagship_setup(jir, JCFG)

    def pairs(gf):
        return np.asarray(gf.lo), np.asarray(gf.hi)

    carried = convert.setup_from_numpy(
        pairs(js.const_cols), pairs(js.sigma_cols), pairs(js.table_cols),
        js.table_np, [pairs(lv) for lv in js.tree.levels], device="cpu")
    for name in ("const_cols", "sigma_cols", "table_cols"):
        assert np.array_equal(tgl.to_u64(getattr(carried, name)),
                              tgl.to_u64(getattr(setup, name))), name
    assert len(carried.tree.levels) == len(setup.tree.levels)
    for a, b in zip(carried.tree.levels, setup.tree.levels):
        assert np.array_equal(tgl.to_u64(a), tgl.to_u64(b))
    assert carried.vk() == setup.vk()
    assert all(np.array_equal(a, b)
               for a, b in zip(carried.table_np, setup.table_np))
    # and back: the port's setup as numpy planes equals the JAX arrays
    back = convert.setup_to_numpy(setup)
    assert np.array_equal(back["sigma_cols"][0], np.asarray(js.sigma_cols.lo))
    assert np.array_equal(back["sigma_cols"][1], np.asarray(js.sigma_cols.hi))


def test_prove_from_a_carried_setup_gives_the_same_proof(port_run):
    """A setup carried across as numpy arrays proves like the port's own."""
    ir, setup, proof = port_run
    as_np = convert.setup_to_numpy(setup)
    carried = convert.setup_from_numpy(
        as_np["const_cols"], as_np["sigma_cols"], as_np["table_cols"],
        as_np["table_np"], as_np["tree_levels"], device="cpu")
    witness = tfl.flagship_witness(ir, seed=42, device="cpu")
    again = tpk.prove(ir, carried, witness, TCFG, device="cpu")
    assert tserde.proof_to_json(again) == tserde.proof_to_json(proof)


def test_witness_matches_jax_witness():
    tw = tfl.flagship_witness(tfl.flagship_ir(log_n=5, width=9), seed=3,
                              device="cpu")
    jw = jfl.flagship_witness(jfl.flagship_ir(log_n=5, width=9), seed=3)
    assert np.array_equal(tgl.to_u64(tw),
                          convert.pairs_to_u64(np.asarray(jw.lo),
                                               np.asarray(jw.hi)))


def _unstratified(ir):
    return dataclasses.replace(ir, gate_part_degrees=None,
                               gate_part_cols=None)


def test_stratify_derives_the_declared_meta():
    ir = tfl.flagship_ir(log_n=6, width=8)
    strat = tpk.stratify(_unstratified(ir))
    assert strat.gate_part_degrees == ir.gate_part_degrees == (8, 3)
    assert strat.gate_part_cols == ir.gate_part_cols
    jdegs, jcols = jpk.derive_gate_part_meta(jfl.flagship_ir(log_n=6, width=8))
    assert (jdegs, jcols) == tpk.derive_gate_part_meta(ir)


def test_prove_refuses_an_unstratified_circuit(port_run):
    """(The name dates from when the unstratified quotient was not ported
    and `prove` raised.) `prove` now takes a circuit without
    `gate_part_degrees`: every family runs on every coset, and the proof is
    the stratified one, value for value."""
    ir, setup, proof = port_run
    witness = tfl.flagship_witness(ir, seed=42, device="cpu")
    got = tpk.prove(_unstratified(ir), setup, witness, TCFG, device="cpu")
    assert tserde.proof_to_json(got) == tserde.proof_to_json(proof)


def test_a_second_circuit_without_lookups_proves_and_verifies():
    """The no-lookup branches of prove/verify, on a tiny circuit of its own."""
    def gates(alg, w, w_next, c):
        return [alg.mul(c[0], alg.sub(alg.mul(w[0], w[1]), w[2]))]

    ir = tpk.stratify(tpk.PlonkishIR(
        log_n=4, num_witness=3, num_const=1, gate_degree=3,
        num_gate_constraints=1, eval_gates=gates, copy_chunk=2,
        public_input_cells=((2, 1),)))
    n = 16
    rng = np.random.default_rng(9)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    cols = np.stack([a, b, np.array([int(x) * int(y) % P for x, y in zip(a, b)],
                                    dtype=np.uint64)])
    cfg = tpk.PlonkishConfig(rate=2, cap_size=2, num_queries=4,
                             final_fri_size=4)
    setup = tpk.build_setup(ir, np.ones((1, n), dtype=object),
                            tpk.CopyWiring.identity(), cfg, device="cpu")
    proof = tpk.prove(ir, setup, tgl.from_u64(cols, "cpu"), cfg, device="cpu")
    assert proof.ood_stage3 == [] and proof.stage3_cap.shape == (0, 4)
    assert tpk.verify(ir, setup.vk(), proof, cfg, device="cpu", strict=True)
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    assert tpk.verify(ir, setup.vk(), bad, cfg, device="cpu") is False
    # an unsatisfying witness does not verify
    cols[2, 5] = (int(cols[2, 5]) + 1) % P
    wrong = tpk.prove(ir, setup, tgl.from_u64(cols, "cpu"), cfg, device="cpu")
    assert tpk.verify(ir, setup.vk(), wrong, cfg, device="cpu") is False


def _product_circuit():
    """Three columns, w0 * w1 = w2 on every row, public inputs on rows 1-3
    of two columns: the quotient's public-input terms over several rows."""
    def gates(alg, w, w_next, c):
        return [alg.mul(c[0], alg.sub(alg.mul(w[0], w[1]), w[2]))]

    ir = tpk.stratify(tpk.PlonkishIR(
        log_n=4, num_witness=3, num_const=1, gate_degree=3,
        num_gate_constraints=1, eval_gates=gates, copy_chunk=2,
        public_input_cells=((2, 1), (0, 2), (2, 3), (1, 3))))
    n = 16
    rng = np.random.default_rng(11)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    cols = np.stack([a, b, np.array([int(x) * int(y) % P for x, y in zip(a, b)],
                                    dtype=np.uint64)])
    cfg = tpk.PlonkishConfig(rate=2, cap_size=2, num_queries=4,
                             final_fri_size=4)
    setup = tpk.build_setup(ir, np.ones((1, n), dtype=object),
                            tpk.CopyWiring.identity(), cfg, device="cpu")
    return ir, setup, tgl.from_u64(cols, "cpu"), cfg


def _builder_circuit():
    """`tests/test_torch_builder.py`'s random program (every op kind,
    Poseidon2 tiles, public outputs) at 120 steps, finalized and
    filled."""
    from tests.test_torch_builder import random_program
    from zkevm_harness_tpu_torch.circuits import builder as tbd
    b, asg = random_program(tbd, steps=120)
    built = b.finalize()
    cfg = tpk.PlonkishConfig(rate=2, cap_size=4, num_queries=4,
                             final_fri_size=8)
    return (built.ir, built.setup(cfg, device="cpu"),
            b.fill_witness(asg, device="cpu"), cfg)


@pytest.mark.parametrize("circuit", ["flagship", "product", "builder"])
def test_byte_bounded_blocks_give_the_one_block_proof(monkeypatch, circuit):
    """The prover's blocked passes (the quotient's gate, copy and public-
    input terms, stage 2's copy columns, DEEP, the streamed LDEs) and the
    quotient's gate parts take their natural blocks on short domains and
    hold `_BLOCK_BYTES` beyond `_BLOCKED_ROWS`. With every domain counted
    long and a budget of one row a block, so that every sum and every gate
    part runs over many blocks (a block holds one column of n rows), the
    proof is the one of the natural blocks, every row at once (field
    addition is exact, a constraint reads its row and the next): for the
    flagship, the golden bytes."""
    if circuit == "flagship":
        ir = tfl.flagship_ir(log_n=6, width=8)
        cfg = TCFG
        setup = tfl.flagship_setup(ir, cfg, device="cpu")
        witness = tfl.flagship_witness(ir, seed=42, device="cpu")
    elif circuit == "builder":
        ir, setup, witness, cfg = _builder_circuit()
    else:
        ir, setup, witness, cfg = _product_circuit()
    proofs = []
    for blocked_rows, budget in ((1 << 40, 1 << 29), (1, 8 << ir.log_n)):
        monkeypatch.setattr(tpk, "_BLOCKED_ROWS", blocked_rows)
        monkeypatch.setattr(tpk, "_BLOCK_BYTES", budget)
        proofs.append(tserde.proof_to_json(
            tpk.prove(ir, setup, witness, cfg, device="cpu")))
    assert tpk._block_rows(1 << ir.log_n, tpk._WSUM_CHUNK) == 1
    assert proofs[0] == proofs[1]
    if circuit == "flagship":
        assert json.loads(json.dumps(proofs[1])) == \
            _load("flagship_log6_proof.json")
    else:
        proof = convert.proof_from_json(proofs[1])
        assert tpk.verify(ir, setup.vk(), proof, cfg, device="cpu",
                          strict=True)


@pytest.mark.parametrize("width", [21, 8, 1])
def test_streamed_commitment_is_the_kept_one(monkeypatch, width):
    """Without its LDE kept, a bundle's commitment is made a block of whole
    rate-8 chunks of columns at a time (here 8 columns a block): the tree
    of the LDE made at once, level for level."""
    rng = np.random.default_rng(width)
    coeffs = tgl.from_u64(rng.integers(0, P, size=(width, 16),
                                       dtype=np.uint64), "cpu")
    lde, kept = tpk._commit_cols_from_coeffs(coeffs, 64, 4)
    monkeypatch.setattr(tpk, "_BLOCKED_ROWS", 1)
    monkeypatch.setattr(tpk, "_BLOCK_BYTES", 8)
    none, streamed = tpk._commit_cols_from_coeffs(coeffs, 64, 4,
                                                  keep_lde=False)
    assert none is None and lde.shape == (width, 64)
    assert len(kept.levels) == len(streamed.levels)
    for a, b in zip(kept.levels, streamed.levels):
        assert torch.equal(a, b)


@pytest.mark.parametrize("log_rows,natural,want", [
    (16, 256, 256), (19, 256, 256), (20, 1024, 1024), (21, 1024, 32),
    (22, 256, 16), (23, 256, 8), (24, 1024, 4), (23, 4, 4)])
def test_blocks_are_natural_up_to_the_blocked_rows(log_rows, natural, want):
    """A blocked pass keeps its natural block (256 values, 1,024 columns)
    on rows of up to 2^20 points, the flagship's and the MainVM's, and
    holds 512 MiB a block on longer ones, never more than its natural
    block."""
    assert tpk._BLOCKED_ROWS == 1 << 20 and tpk._BLOCK_BYTES == 1 << 29
    assert tpk._block_rows(1 << log_rows, natural) == want
    # a block of a longer domain's rows is sized by the bytes of its rows
    assert tpk._block_rows(1 << 20, natural, 1 << 23) == min(natural, 64)
