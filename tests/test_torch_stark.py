"""The port's AIR STARK engine against the JAX package's: the fib-mul AIR of
tests/test_stark.py, its trace handed to both engines through `convert`, the
port's proof equal to the golden JAX proof byte for byte
(test_artifacts/stark_fib_log6_proof.json, tools/gen_cli_golden.py), the
four cases of tests/test_stark.py held by the port, and the JAX verifier
accepting the port's proof after a JSON round trip. No fresh JAX proof is
made here. Tolerance 0: field integers."""

import copy
import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.prover import stark as jst
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import stark as tst
from zkevm_harness_tpu_torch.utils import serde as tserde

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
LOG_N = golden.STARK_GOLDEN_LOG_N
TCFG = tst.StarkConfig(**golden.STARK_GOLDEN_CONFIG)
JCFG = jst.StarkConfig(**golden.STARK_GOLDEN_CONFIG)


def _air(mod):
    return mod.Air(width=3, log_n=LOG_N, constraint_degree=2,
                   num_transitions=3,
                   eval_transitions=golden.fib_mul_transitions,
                   boundary=golden.FIB_MUL_BOUNDARY)


def _jax_trace():
    return jgl.from_int(np.array(golden.fib_mul_trace(LOG_N), dtype=object))


def _port_trace(jtrace):
    """The JAX (lo, hi) trace as the port's int64 tensor."""
    return convert.tensor_from_pairs(np.asarray(jtrace.lo),
                                     np.asarray(jtrace.hi), "cpu")


@pytest.fixture(scope="module")
def port_proof():
    return tst.prove(_air(tst), _port_trace(_jax_trace()), TCFG, device="cpu")


def test_trace_carrier_round_trips():
    jtrace = _jax_trace()
    t = _port_trace(jtrace)
    lo, hi = convert.pairs_from_tensor(t)
    assert np.array_equal(lo, np.asarray(jtrace.lo))
    assert np.array_equal(hi, np.asarray(jtrace.hi))
    assert [int(v) for v in tgl.to_ints(t)[1]] == golden.fib_mul_trace(LOG_N)[1]


def test_proof_equals_golden(port_proof):
    with open(os.path.join(ART, f"stark_fib_log{LOG_N}_proof.json")) as f:
        want = json.load(f)
    assert json.loads(json.dumps(tserde.proof_to_json(port_proof))) == want


def test_stark_proof_in_registry(port_proof):
    back = convert.proof_from_json(tserde.proof_to_json(port_proof))
    assert isinstance(back, tst.StarkProof)
    assert tst.verify(_air(tst), back, TCFG, device="cpu", strict=True)


def test_prove_verify_roundtrip(port_proof):
    assert tst.verify(_air(tst), port_proof, TCFG, device="cpu", strict=True)


def test_verify_rejects_tampered_ood(port_proof):
    bad = copy.deepcopy(port_proof)
    bad.ood_trace[0] = ((bad.ood_trace[0][0] + 1) % P, bad.ood_trace[0][1])
    assert not tst.verify(_air(tst), bad, TCFG, device="cpu")


def test_verify_rejects_tampered_opening(port_proof):
    bad = copy.deepcopy(port_proof)
    k = sorted(bad.trace_openings.keys())[0]
    row = list(bad.trace_openings[k])
    row[0] = (row[0] + 1) % P
    bad.trace_openings[k] = row
    assert not tst.verify(_air(tst), bad, TCFG, device="cpu")


def test_verify_rejects_wrong_trace():
    n = 1 << LOG_N
    t = _port_trace(_jax_trace())
    t[2, n // 2] ^= 1  # corrupt one cell mid-trace
    proof = tst.prove(_air(tst), t, TCFG, device="cpu")
    assert not tst.verify(_air(tst), proof, TCFG, device="cpu")


@pytest.mark.slow  # the JAX verifier compiles for about 25 s
def test_jax_verifier_accepts_the_port_proof(port_proof):
    jproof = convert.proof_to_package(port_proof, jserde.default_registry())
    assert isinstance(jproof, jst.StarkProof)
    assert jst.verify(_air(jst), jproof, JCFG, strict=True)


def test_zh_over_last_inv_equals_host_form():
    """The device form of 1/Z_Ht and (x - w^{N-1}) equals the JAX package's
    host ints."""
    n, lde, shift = 1 << LOG_N, TCFG.lde_factor, tgl.MULTIPLICATIVE_GENERATOR
    zh_inv, xml = tst._zh_over_last_inv(n, lde, shift, "cpu")
    jz, jx = jst._zh_over_last_inv(n, lde, shift)
    assert np.array_equal(tgl.to_u64(zh_inv), jgl.to_u64(jz))
    assert np.array_equal(tgl.to_u64(xml), jgl.to_u64(jx))


def test_prove_refuses_a_trace_on_another_device():
    with pytest.raises(ValueError, match="trace is on"):
        tst.prove(_air(tst), tgl.zeros((3, 1 << LOG_N), "cpu"), TCFG,
                  device="meta")
