"""The port's EIP-4844 blob branch — BLS12-381 (`utils/bls12_381.py`, the
native MSM of `utils/native.py`), KZG (`utils/kzg.py`), the witness chain
(`witness/eip4844.py`), the blob circuit (`circuits/eip4844_circuit.py`)
and its typed surface in `prover/layers.py` — held against the JAX package
and the committed golden artifacts (`tools/gen_wrap_golden.py`: the
16-point testing KZG settings, the witness chain of the JAX tests' blob and
the blob circuit's VK and proof at 16 elements), value for value (integers,
tolerance 0).

Tier-1 tests start no JAX proof; proving the blob to equal bytes on the
CPU is `slow`.
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest

from zkevm_harness_tpu.circuits import eip4844_circuit as je4
from zkevm_harness_tpu.circuits import ffarith as jff
from zkevm_harness_tpu.utils import bls12_381 as jbls
from zkevm_harness_tpu.witness import eip4844 as jw4844
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import eip4844_circuit as te4
from zkevm_harness_tpu_torch.circuits import ffarith as tff
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover import satisfy
from zkevm_harness_tpu_torch.utils import bls12_381 as tbls
from zkevm_harness_tpu_torch.utils import kzg as tkzg
from zkevm_harness_tpu_torch.utils import native
from zkevm_harness_tpu_torch.utils.native import keccak256
from zkevm_harness_tpu_torch.witness import eip4844 as tw4844

P = tgl.P
R = tbls.R
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
N = 16
CFG = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


GOLDEN = _load("eip4844_golden.json")
BLOB = bytes.fromhex(GOLDEN["blob"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small CPU tensors here run faster on one thread, and do not
    stall on the other test processes' threads."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u64(gf):
    """A JAX field array as uint64."""
    return np.asarray(gf.lo).astype(np.uint64) | \
        (np.asarray(gf.hi).astype(np.uint64) << np.uint64(32))


# -- BLS12-381 ----------------------------------------------------------------

def _g1(mod, k):
    return mod.g1_mul(mod.G1_GENERATOR, k)


def test_bls12_381_group_laws_and_encodings_equal_to_jax():
    rng = random.Random(381)
    a, b = rng.randrange(R), rng.randrange(R)
    for mod in (tbls, jbls):
        assert mod.g1_add(_g1(mod, a), _g1(mod, b)) == _g1(mod, a + b)
        assert mod.g1_add(_g1(mod, a), mod.g1_neg(_g1(mod, a))) is None
        assert mod.g1_mul(mod.G1_GENERATOR, R) is None
        assert mod.g2_add(mod.g2_mul(mod.G2_GENERATOR, a),
                          mod.g2_mul(mod.G2_GENERATOR, b)) == \
            mod.g2_mul(mod.G2_GENERATOR, a + b)
    p = _g1(tbls, a)
    assert p == _g1(jbls, a) and tbls.g1_is_on_curve(p)
    assert tbls.g1_compress(p) == jbls.g1_compress(p)
    assert tbls.g1_decompress(tbls.g1_compress(p)) == p
    assert tbls.g2_decompress(bytes.fromhex(tkzg.SETUP_G2_1_HEX)) == \
        jbls.g2_decompress(bytes.fromhex(tkzg.SETUP_G2_1_HEX))


def test_bls12_381_msm_native_python_and_naive_sum_agree(monkeypatch):
    rng = random.Random(3)
    pts = [_g1(tbls, rng.randrange(1, R)) for _ in range(8)] + [None]
    sc = [rng.randrange(R) for _ in range(9)]
    naive = None
    for p, s in zip(pts, sc):
        naive = tbls.g1_add(naive, tbls.g1_mul(p, s) if p else None)
    before = native.MSM_CALLS["bls12381_msm"]
    assert tbls.g1_msm(pts, sc) == naive == jbls.g1_msm(pts, sc)
    assert native.MSM_CALLS["bls12381_msm"] == before + 1

    def unavailable(*_a):
        raise RuntimeError("native bls12381_msm unavailable")

    monkeypatch.setattr(native, "bls12381_msm", unavailable)
    assert tbls.g1_msm(pts, sc) == naive   # the Python Pippenger


def test_bls12_381_pairing_is_bilinear_and_equal_to_jax():
    a, b = 3, 11
    t = tbls.pairing(_g1(tbls, a), tbls.g2_mul(tbls.G2_GENERATOR, b))
    assert t == tbls.pairing(_g1(tbls, a * b), tbls.G2_GENERATOR)
    assert t == jbls.pairing(_g1(jbls, a), jbls.g2_mul(jbls.G2_GENERATOR, b))
    assert t != tbls.pairing(_g1(tbls, a * b + 1), tbls.G2_GENERATOR)


def test_fr_fft_equal_to_jax():
    rng = random.Random(4)
    poly = [rng.randrange(R) for _ in range(N)]
    evals = tw4844.fr_fft(poly)
    assert evals == jw4844.fr_fft(poly)
    w = tbls.fr_root_of_unity(4)
    x = pow(w, 5, R)
    assert evals[5] == sum(c * pow(x, i, R) for i, c in enumerate(poly)) % R
    assert tw4844.pubdata_to_monomial_poly(BLOB, N) == \
        jw4844.pubdata_to_monomial_poly(BLOB, N)


# -- KZG and the witness chain ------------------------------------------------

@pytest.fixture(scope="module")
def settings():
    return tkzg.KzgSettings.testing(N)


def test_kzg_testing_settings_equal_the_golden(settings):
    want = GOLDEN["settings"]
    assert settings.domain_size == want["domain_size"] == N
    assert settings.roots_of_unity == want["roots_of_unity"]
    assert [list(p) for p in settings.g1_lagrange_brp] == \
        want["g1_lagrange_brp"]
    assert [list(c) for c in settings.setup_g2_1] == want["setup_g2_1"]


def test_witness_chain_equals_the_golden(settings):
    wit = tw4844.generate_eip4844_witness(BLOB, settings)
    assert convert.eip4844_witness_to_json(wit) == GOLDEN["witness"]
    assert convert.eip4844_witness_from_json(GOLDEN["witness"]) == wit
    chunks, linear_hash, versioned_hash, _ = wit
    assert linear_hash == keccak256(BLOB) and versioned_hash[0] == 1
    x = int.from_bytes(keccak256(linear_hash + versioned_hash)[16:],
                       "big") % R
    assert x == GOLDEN["x"]
    assert [int.from_bytes(c, "little") for c in chunks] == \
        GOLDEN["elements"]


def test_kzg_proof_opens_the_blob_polynomial(settings):
    """A KZG opening of the blob's commitment at the chain's point verifies
    and gives the Horner fold of the chunks; a wrong value is refused."""
    poly = tw4844.pubdata_to_monomial_poly(BLOB, N)
    brp = tkzg.bit_reverse_permute(tw4844.fr_fft(poly), 4)
    commitment = tkzg.compute_commitment(settings, brp)
    z = GOLDEN["x"]
    y, proof = tkzg.compute_proof(settings, brp, z)
    assert y == sum(c * pow(z, i, R) for i, c in enumerate(poly)) % R
    assert tkzg.verify_kzg_proof(settings, commitment, z, y, proof)
    assert not tkzg.verify_kzg_proof(settings, commitment, z, (y + 1) % R,
                                     proof)


# -- the blob circuit ---------------------------------------------------------

@pytest.fixture(scope="module")
def blob():
    """Both packages' programs and instances; the JAX instance takes the
    port's binding challenges (its own draw compiles for seconds), which
    the golden proof's first public inputs pin."""
    tp = te4.build_eip4844_program(N, limb_bits=8)
    jp = je4.build_eip4844_program(N, limb_bits=8)
    tinst = te4.instance_inputs(GOLDEN["elements"], GOLDEN["x"],
                                device="cpu")
    jinst = je4.instance_inputs(GOLDEN["elements"], GOLDEN["x"],
                                tinst.challenge, tinst.gamma)
    return tp, jp, tinst, jinst


def test_blob_layout_equal_to_jax(blob):
    tp, jp, _ti, _ji = blob
    tl, jl = tp.layout, jp.layout
    assert (tl.log_n, tl.num_rows, tl.pi_cells, tl.bind_c) == \
        (jl.log_n, jl.num_rows, jl.pi_cells, jl.bind_c)
    assert (tp.x_row, tp.e_rows) == (jp.x_row, jp.e_rows)
    assert np.array_equal(tl.const_rows, np.asarray(
        jl.const_rows, dtype=object).astype(np.uint64))
    w = convert.copy_wiring_from_dense(jl.permutation)
    order = np.argsort(w.cells)
    assert np.array_equal(tl.wiring.cells, w.cells[order])
    assert np.array_equal(tl.wiring.succ, w.succ[order])


def test_blob_ir_list_path_calls_equal_to_jax(blob):
    """The in-circuit verifier replays the blob IR's gates (the scheduler's
    blob slot): the port's per-constraint list path makes the JAX
    package's algebra calls, in its order."""
    from tests.test_torch_recursion import _calls
    tp, jp, _ti, _ji = blob
    jir = jff.ff_ir(jp.layout.params, jp.layout.log_n, jp.layout.num_rows,
                    bind_c=jp.layout.bind_c)
    tlog, tout = _calls(tff.layout_ir(tp.layout))
    jlog, jout = _calls(jir)
    assert len(tout) == len(jout) and len(tlog) > 1000
    assert tlog == jlog


def test_blob_witness_and_public_inputs_equal_to_jax(blob):
    tp, jp, tinst, jinst = blob
    golden_pis = convert.proof_from_json(
        _load("eip4844_n16_proof.json")).public_inputs
    assert [tinst.challenge % P, tinst.gamma % P] == \
        [int(v) for v in golden_pis[:2]]
    tir = tff.layout_ir(tp.layout)
    jir = jff.ff_ir(jp.layout.params, jp.layout.log_n, jp.layout.num_rows,
                    bind_c=True)
    tW = te4.eip4844_witness(tp, tir, tinst, device="cpu")
    assert np.array_equal(tgl.to_u64(tW),
                          _u64(je4.eip4844_witness(jp, jir, jinst)))
    pis = te4.expected_public_inputs(tp, tinst)
    assert pis == [int(v) for v in je4.expected_public_inputs(jp, jinst)]
    assert satisfy.check_satisfied(tir, tgl.to_u64(tW),
                                   tp.layout.const_rows.T, tp.layout.wiring,
                                   pis) == []
    assert te4.opening_value(tp, pis) == te4.horner_fold(
        GOLDEN["elements"], GOLDEN["x"])


@pytest.fixture(scope="module")
def blob_setup():
    with tly.engine_override(CFG):
        sd, prog = tly.create_eip4844_setup_data(N, limb_bits=8,
                                                 device="cpu")
    return sd, prog


def _verify(elements, x, proof):
    with tly.engine_override(CFG):
        return tly.verify_eip4844(elements, x, proof, n_elements=N,
                                  limb_bits=8, device="cpu")


def test_blob_vk_equals_the_golden(blob_setup):
    sd, _prog = blob_setup
    assert sd.vk == _load("eip4844_n16_vk.json")


def test_blob_setup_folds_at_least_once():
    """A final FRI size as large as the blob circuit's LDE (512 points at
    16 elements, rate 2) would not fold: the setup refuses it rather than
    prove under another config; one below it is kept as given."""
    big = tpk.PlonkishConfig(rate=2, cap_size=4, num_queries=1,
                             final_fri_size=512)
    fits = dataclasses.replace(big, final_fri_size=256)
    with pytest.raises(ValueError, match="does not fold"):
        blob_config(big)
    assert blob_config(fits) == fits
    assert blob_config(CFG) == CFG


def blob_config(cfg):
    with tly.engine_override(cfg):
        return tly.create_eip4844_setup_data(N, limb_bits=8,
                                             device="cpu")[0].config


@pytest.mark.parametrize("what", ("element", "point", "opening"))
def test_blob_tampered_statement_rejected(blob_setup, what):
    """The golden proof is refused for another blob element, another point,
    or with its opening value changed."""
    proof = convert.proof_from_json(_load("eip4844_n16_proof.json"))
    elements, x = list(GOLDEN["elements"]), GOLDEN["x"]
    if what == "element":
        elements[3] = (elements[3] + 1) % R
    elif what == "point":
        x = (x + 1) % R
    else:
        pis = list(proof.public_inputs)
        pis[-1] = (int(pis[-1]) + 1) % P
        proof = dataclasses.replace(proof, public_inputs=pis)
    assert _verify(elements, x, proof) is False


@pytest.mark.parametrize("what", ("ood", "cap", "public_input"))
def test_blob_stark_verifier_refuses_a_tampered_proof(blob_setup, what):
    """Past the public-input comparison: the STARK verifier itself refuses
    the golden proof with an OOD value, a cap entry or a public input
    changed."""
    sd, _prog = blob_setup
    proof = convert.proof_from_json(_load("eip4844_n16_proof.json"))
    assert tpk.verify(sd.ir, sd.vk, proof, sd.config, device="cpu")
    if what == "ood":
        ood = list(proof.ood_witness)
        ood[3] = ((int(ood[3][0]) + 1) % P, ood[3][1])
        bad = dataclasses.replace(proof, ood_witness=ood)
    elif what == "cap":
        cap = np.array(proof.witness_cap, copy=True)
        cap[0, 0] = (int(cap[0, 0]) + 1) % P
        bad = dataclasses.replace(proof, witness_cap=cap)
    else:
        pis = list(proof.public_inputs)
        pis[-1] = (int(pis[-1]) + 1) % P
        bad = dataclasses.replace(proof, public_inputs=pis)
    assert tpk.verify(sd.ir, sd.vk, bad, sd.config, device="cpu") is False


@pytest.mark.slow
def test_blob_proof_equals_the_golden_bytes_and_verifies(blob_setup):
    with tly.engine_override(CFG):
        proof = tly.prove_eip4844(GOLDEN["elements"], GOLDEN["x"],
                                  n_elements=N, limb_bits=8, device="cpu")
    got = convert.json_roundtrip(convert.proof_to_json(proof))
    assert got == _load("eip4844_n16_proof.json")
    assert _verify(GOLDEN["elements"], GOLDEN["x"], proof)
