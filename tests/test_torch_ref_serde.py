"""The port's reference-dialect serde against the JAX package's: the golden
flagship proof (test_artifacts/flagship_log6_proof.json), loaded into each
package's proof class, goes through each package's
`proof_to_reference_json` to the same JSON (host code: no JAX proof runs);
the VK export is the same; the port's round trip verifies unchanged and a
tampered one is refused. Key sets are tests/test_ref_serde.py's."""

import json
import os

import pytest

from tests.test_ref_serde import (REFERENCE_FIXED_KEYS, REFERENCE_PROOF_KEYS,
                                  REFERENCE_VK_KEYS)
from zkevm_harness_tpu.circuits import flagship as jfl
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import ref_serde as jref
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.circuits import flagship as tfl
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import ref_serde as tref

ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
KW = dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8)
TCFG = tpk.PlonkishConfig(**KW)
JCFG = jpk.PlonkishConfig(**KW)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def proofs():
    data = _load("flagship_log6_proof.json")
    return (convert.proof_from_json(data),
            convert.proof_from_json(data, jserde.default_registry()))


def _dumped(doc):
    return json.dumps(doc, sort_keys=False)


@pytest.mark.parametrize("ctype", [1, 8, 13])
def test_proof_reference_json_equals_jax(proofs, ctype):
    tproof, jproof = proofs
    got = tref.proof_to_reference_json(ctype, tproof, TCFG)
    assert _dumped(got) == _dumped(jref.proof_to_reference_json(ctype, jproof,
                                                                JCFG))
    body = got[tref.circuit_name(ctype)]
    assert REFERENCE_PROOF_KEYS <= set(body)
    assert set(body) - REFERENCE_PROOF_KEYS <= {
        "lookup_oracle_cap", "values_at_z_layout", "query_positions"}


def test_vk_reference_json_equals_jax():
    tir = tfl.flagship_ir(log_n=6, width=8)
    setup = tfl.flagship_setup(tir, TCFG, device="cpu")
    got = tref.vk_to_reference_json(1, tir, setup, TCFG)
    # the JAX function reads the IR's shape and the setup's cap alone
    want = jref.vk_to_reference_json(1, jfl.flagship_ir(log_n=6, width=8),
                                     setup, JCFG)
    assert _dumped(got) == _dumped(want)
    body = got["MainVM"]
    assert set(body) == REFERENCE_VK_KEYS
    assert set(body["fixed_parameters"]) == REFERENCE_FIXED_KEYS
    assert [v for row in body["setup_merkle_tree_cap"] for v in row] == \
        [int(v) for v in _load("flagship_log6_vk.json")]


def test_round_trip_verifies_and_tamper_rejected(proofs):
    tproof, _ = proofs
    ir = tfl.flagship_ir(log_n=6, width=8)
    vk = [int(v) for v in _load("flagship_log6_vk.json")]
    doc = json.loads(json.dumps(tref.proof_to_reference_json(1, tproof, TCFG)))
    ctype, back = tref.reference_json_to_proof(doc)
    assert ctype == 1
    assert tpk.verify(ir, vk, back, TCFG, device="cpu", strict=True)
    doc["MainVM"]["public_inputs"][0] += 1
    _, bad = tref.reference_json_to_proof(doc)
    assert not tpk.verify(ir, vk, bad, TCFG, device="cpu")


def test_names_match_jax():
    assert tref.BASE_CIRCUIT_NAMES == jref.BASE_CIRCUIT_NAMES
    for t in range(1, 14):
        assert tref.circuit_type_of(tref.circuit_name(t)) == t


def test_chip_smoke_key_sets_are_the_tests():
    """The card's run checks the reference's key sets as this file's JAX
    counterpart states them."""
    import chip_smoke
    assert chip_smoke.REFERENCE_PROOF_KEYS == REFERENCE_PROOF_KEYS
    assert chip_smoke.REFERENCE_VK_KEYS == REFERENCE_VK_KEYS
    assert chip_smoke.REFERENCE_FIXED_KEYS == REFERENCE_FIXED_KEYS
