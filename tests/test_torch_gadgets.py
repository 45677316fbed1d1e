"""The port's stand-alone gadget circuits (GF(p^2) squaring chain and
inverse cells, FRI fold check, in-circuit transcript, Merkle path) against
the JAX package's: at the shapes of its gadget tests with the fixed inputs
of `golden.py` (`golden.gadget_circuits`, which the card's run proves too),
each VK and proof equals test_artifacts/gadget_*_{vk,proof}.json
(tools/gen_cli_golden.py) byte for byte, and the tampered cases of the JAX
tests are refused. Tolerance 0."""

import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu_torch import golden
from zkevm_harness_tpu_torch.circuits import ext_gadget as eg
from zkevm_harness_tpu_torch.circuits import fri_fold_circuit as fc
from zkevm_harness_tpu_torch.circuits import transcript_gadget as tg
from zkevm_harness_tpu_torch.ops import goldilocks as gl
from zkevm_harness_tpu_torch.ops import merkle as mk
from zkevm_harness_tpu_torch.prover import plonkish as pk
from zkevm_harness_tpu_torch.prover.fri import INV2
from zkevm_harness_tpu_torch.prover.transcript import Transcript
from zkevm_harness_tpu_torch.utils import field_int as fi
from zkevm_harness_tpu_torch.utils import serde

P = gl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
DEV = "cpu"
NAMES = ("ext_chain", "inverse", "fri_fold", "transcript", "merkle")


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gadgets():
    """name -> (ir, setup, witness, cfg, proof)."""
    out = {}
    for name, ir, setup, witness, cfg in golden.gadget_circuits(DEV):
        out[name] = (ir, setup, witness, cfg,
                     pk.prove(ir, setup, witness, cfg, device=DEV))
    assert tuple(out) == NAMES
    return out


def _verify(ir, setup, proof, cfg, strict=None):
    return pk.verify(ir, setup.vk(), proof, cfg, device=DEV, strict=strict)


def _with_public_inputs(proof, pis):
    return pk.PlonkishProof(**{**proof.__dict__, "public_inputs": pis})


def _refused_with_cells(gadget, edits):
    """Prove a copy of the witness with cells (col, row) set to new values;
    True when the verifier refuses that proof."""
    ir, setup, witness, cfg, _proof = gadget
    w = gl.to_u64(witness).astype(object)
    for (col, row), v in edits.items():
        w[col, row] = v % P
    bad = pk.prove(ir, setup, gl.from_int(w, DEV), cfg, device=DEV)
    return not _verify(ir, setup, bad, cfg)


@pytest.mark.parametrize("name", NAMES)
def test_gadget_equals_golden_and_verifies(gadgets, name):
    ir, setup, _w, cfg, proof = gadgets[name]
    assert setup.vk() == [int(v) for v in _load(f"gadget_{name}_vk.json")]
    assert json.loads(json.dumps(serde.proof_to_json(proof))) == \
        _load(f"gadget_{name}_proof.json")
    assert _verify(ir, setup, proof, cfg, strict=True)


# -- GF(p^2) squaring chain ------------------------------------------------

def test_ext_chain_public_inputs_and_forged_power(gadgets):
    ir, setup, _w, cfg, proof = gadgets["ext_chain"]
    a = golden.EXT_CHAIN_BASE
    want = eg.expected_power(a, ir.log_n)
    assert tuple(proof.public_inputs[:2]) == a
    assert tuple(proof.public_inputs[2:]) == want
    forged = _with_public_inputs(proof, list(proof.public_inputs[:2])
                                 + [(want[0] + 1) % P, want[1]])
    assert not _verify(ir, setup, forged, cfg)


def test_ext_chain_broken_chain_rejected(gadgets):
    """The copy chain broken at row 7, every row's gate kept satisfied."""
    w = gl.to_u64(gadgets["ext_chain"][2]).astype(object)
    a7 = (int(w[eg.A0, 7]) + 1) % P
    edits = {(eg.A0, 7): a7, (eg.B0, 7): a7}
    cur = fi.emul((a7, int(w[eg.A1, 7])), (a7, int(w[eg.B1, 7])))
    edits[(eg.C0, 7)], edits[(eg.C1, 7)] = cur
    for i in range(8, 15):
        sq = fi.emul(cur, cur)
        edits[(eg.A0, i)], edits[(eg.A1, i)] = cur
        edits[(eg.B0, i)], edits[(eg.B1, i)] = cur
        edits[(eg.C0, i)], edits[(eg.C1, i)] = sq
        cur = sq
    assert _refused_with_cells(gadgets["ext_chain"], edits)


# -- inverse cells -----------------------------------------------------------

def test_inverse_public_inputs_and_wrong_inverse(gadgets):
    proof = gadgets["inverse"][4]
    assert (proof.public_inputs[0] * proof.public_inputs[1]) % P == 1
    w = gl.to_u64(gadgets["inverse"][2])
    assert _refused_with_cells(gadgets["inverse"], {(1, 3): int(w[1, 3]) + 1})


# -- FRI fold check ----------------------------------------------------------

def _host_fold(a, b, alpha, d):
    """The fold expression fri_verify checks per query."""
    e = fi.escale(fi.eadd(a, b), INV2)
    o = fi.escale(fi.emul(fi.esub(a, b), (fi.finv(d), 0)), INV2)
    return fi.eadd(e, fi.emul(alpha, o))


def test_fri_fold_matches_host_verifier(gadgets):
    ir, _s, _w, _c, proof = gadgets["fri_fold"]
    _witness, folded = fc.fold_witness(ir, golden.FRI_FOLD_ROWS, device=DEV)
    for row, nxt in zip(golden.FRI_FOLD_ROWS, folded):
        assert nxt == _host_fold(*row)
    assert tuple(proof.public_inputs) == folded[0]


@pytest.mark.parametrize("col", [fc.N0, fc.DINV])
def test_fri_fold_forged_cell_rejected(gadgets, col):
    """A forged folded value, and a wrong d_inv."""
    w = gl.to_u64(gadgets["fri_fold"][2])
    assert _refused_with_cells(gadgets["fri_fold"],
                               {(col, 0): int(w[col, 0]) + 1})


# -- in-circuit transcript ---------------------------------------------------

def test_transcript_challenges_and_forged_challenge(gadgets):
    ir, setup, _w, cfg, proof = gadgets["transcript"]
    chunks = [list(c) for c in golden.TRANSCRIPT_CHUNKS]
    assert proof.public_inputs[:4] == [0, 0, 0, 0]
    want = tg.expected_challenges(chunks, [0, 1], device=DEV)
    assert [tuple(proof.public_inputs[4:6]),
            tuple(proof.public_inputs[6:8])] == want
    # one continuous host transcript, absorb and draw interleaved
    tr = Transcript(device=DEV)
    tr.absorb_ints(chunks[0])
    c0 = tr.challenge_ext_ints()
    tr.absorb_ints(chunks[1])
    assert [c0, tr.challenge_ext_ints()] == want
    forged = list(proof.public_inputs)
    forged[4] = (forged[4] + 1) % P
    assert not _verify(ir, setup, _with_public_inputs(proof, forged), cfg)


# -- Merkle path -------------------------------------------------------------

def test_merkle_public_inputs_are_the_tree(gadgets):
    proof = gadgets["merkle"][4]
    leaves = gl.from_int(np.array(golden.MERKLE_LEAVES, dtype=object), DEV)
    root = [int(v) for v in gl.to_u64(mk.build_tree(leaves, 1).cap)[0]]
    idx = golden.MERKLE_INDEX
    assert proof.public_inputs == (list(golden.MERKLE_LEAVES[idx]) + root
                                   + [(idx >> d) & 1 for d in range(2)])


@pytest.mark.parametrize("what", ["root", "path_bit"])
def test_merkle_forged_public_input_rejected(gadgets, what):
    ir, setup, _w, cfg, proof = gadgets["merkle"]
    forged = list(proof.public_inputs)
    if what == "root":
        forged[4] = (forged[4] + 1) % P
    else:
        forged[8] ^= 1
    assert not _verify(ir, setup, _with_public_inputs(proof, forged), cfg)
