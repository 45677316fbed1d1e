"""The port's last proving layers — the compression chain
(`prover/compression.py`, the compression surface of `prover/layers.py`),
the BN254 curve layer (`utils/bn254.py`, the native MSM of
`utils/native.py`), PLONK (`utils/plonk.py`), the "pi" SNARK wrapper
(`utils/snark_wrapper.py`) and `full_chain.py` — held against the JAX
package and the committed golden artifacts (`tools/gen_wrap_golden.py`),
value for value (integers, tolerance 0).

Tier-1 tests start no JAX proof: the JAX side is host Python, or the
committed artifacts (the five-mode chain over the `queue_ir(5)` stand-in,
mode 1 at LDE 32 over the golden tower's scheduler, the "pi" SNARK proof,
and the full chain over the golden tower's block with a blob in the
scheduler's blob slot). Proving to equal bytes on the CPU is `slow`.
"""

import dataclasses
import json
import os
import random

import pytest

from zkevm_harness_tpu.prover import compression as jcp
from zkevm_harness_tpu.utils import bn254 as jbn
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import queue_circuit as tqc
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import compression as tcp
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.utils import bn254 as tbn
from zkevm_harness_tpu_torch.utils import native
from zkevm_harness_tpu_torch.utils import plonk as tpl
from zkevm_harness_tpu_torch.utils import snark_wrapper as tsw
from zkevm_harness_tpu_torch.utils.data_source import InMemoryDataSource

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
STANDIN_SCHED = tpk.PlonkishConfig(rate=2, cap_size=4, num_queries=2,
                                   final_fri_size=8)
STANDIN_MODE = tpk.PlonkishConfig(rate=2, cap_size=4, num_queries=1,
                                  final_fri_size=8)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _proof_json(proof):
    return convert.json_roundtrip(convert.proof_to_json(proof))


def _bump_pi(proof, k=0):
    pis = list(proof.public_inputs)
    pis[k] = (int(pis[k]) + 1) % P
    return dataclasses.replace(proof, public_inputs=pis)


GOLDEN_PI = _load("tower_golden_summary.json")["scheduler_pi"]
_rng = random.Random(8)
STARK_PIS = ([1, 2, 3, 4], [0, 0, 0, 0], [P - 1] * 4, GOLDEN_PI,
             [_rng.randrange(P) for _ in range(4)])


# -- compression orchestration ------------------------------------------------

@pytest.mark.parametrize("pis", STARK_PIS)
def test_compress_stark_pi_to_snark_pi_equal_to_jax(pis):
    got = tcp.compress_stark_pi_to_snark_pi(pis)
    assert got == jcp.compress_stark_pi_to_snark_pi(pis)
    assert 0 <= got < tcp.BN254_FR


@pytest.mark.parametrize("layers", range(1, 6))
def test_wrapper_config_equal_to_jax(layers, monkeypatch):
    t, j = tcp.WrapperConfig(layers), jcp.WrapperConfig(layers)
    assert t.get_compression_types() == j.get_compression_types()
    assert t.get_final_compression_type() == j.get_final_compression_type()
    monkeypatch.setenv("COMPRESSION_NUM", str(layers))
    assert tcp.get_testing_wrapper_config() == t
    for bad in (0, 6):
        with pytest.raises(AssertionError):
            tcp.WrapperConfig(bad)


def test_wrap_proof_chains_modes_and_resumes():
    """`wrap_proof` over injected provers: modes 1..k-1 then the final
    mode, each fed the previous proof; a resumed run proves the final mode
    only; a failed verification aborts."""
    calls = []

    def prove_fn(mode, prev):
        calls.append(mode)
        return {"mode": mode, "prev": prev["mode"]}, {"vk": mode}

    src = InMemoryDataSource()
    out = tcp.wrap_proof({"mode": 0}, [1, 2, 3, 4], tcp.WrapperConfig(3),
                         prove_fn, lambda m, p, v: p["mode"] == m, src)
    assert calls == [1, 2, 3] and out["final_proof"]["prev"] == 2
    assert out["snark_public_input"] == \
        jcp.compress_stark_pi_to_snark_pi([1, 2, 3, 4])
    calls.clear()
    tcp.wrap_proof({"mode": 0}, [1, 2, 3, 4], tcp.WrapperConfig(3),
                   prove_fn, lambda m, p, v: True, src)
    assert calls == [3]
    with pytest.raises(AssertionError):
        tcp.wrap_proof({"mode": 0}, [0] * 4, tcp.WrapperConfig(2),
                       prove_fn, lambda m, p, v: False)


def test_compression_engine_config_is_the_production_ladder():
    got = [tly.compression_engine_config(m) for m in range(1, 6)]
    assert [c.rate for c in got] == [32, 512, 1024, 2048, 4096]
    assert got[0] == tpk.PlonkishConfig(rate=32, cap_size=16,
                                        num_queries=40, final_fri_size=32)
    with tly.engine_override(STANDIN_MODE):
        assert tly.compression_engine_config(1) == STANDIN_MODE


# -- the five-mode chain over the stand-in scheduler --------------------------

@pytest.fixture(scope="module")
def standin():
    """The stand-in scheduler (`queue_ir(5)`) and, per mode, the circuit
    that verifies the previous layer (synthesized and finalized only) with
    the golden VK and proof of that mode."""
    inner = {1: (tqc.queue_ir(5), STANDIN_SCHED,
                 _load("wrap_standin_scheduler_vk.json"))}
    from zkevm_harness_tpu_torch.circuits import verifier_circuit as tvc
    for mode in range(1, 6):
        ir, cfg, _vk = inner[mode]
        b, _lay = tvc.synthesize_verifier(ir, cfg, slots=8)
        inner[mode + 1] = (b.finalize().ir, STANDIN_MODE,
                           _load(f"wrap_standin_mode{mode}_vk.json"))
    return inner


@pytest.fixture
def one_thread():
    """The small CPU tensors of a verify run faster on one thread, and do
    not stall on the other test processes' threads."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", range(1, 6))
def test_golden_mode_proof_binds_the_previous_layer_and_verifies(
        standin, mode, one_thread):
    """Each golden mode proof's public inputs are the previous layer's VK
    and public inputs, and its shape is the port's synthesized verifier's
    (log_n, width, one public input per bound value); the port's verifier
    over that circuit and the golden VK accepts it and refuses it with one
    of the inner public inputs changed."""
    proof = convert.proof_from_json(_load(f"wrap_standin_mode{mode}_"
                                          "proof.json"))
    prev = convert.proof_from_json(_load(
        "wrap_standin_scheduler_proof.json" if mode == 1
        else f"wrap_standin_mode{mode - 1}_proof.json"))
    _ir, _cfg, prev_vk = standin[mode]
    assert [int(v) for v in proof.public_inputs] == \
        [int(v) for v in prev_vk] + [int(v) for v in prev.public_inputs]
    ir = standin[mode + 1][0]
    assert len(ir.public_input_cells) == len(proof.public_inputs)
    assert (ir.log_n, ir.num_witness) == ((11, 60) if mode == 1
                                          else (12, 60))
    vk = standin[mode + 1][2]
    assert tpk.verify(ir, vk, proof, STANDIN_MODE, device="cpu")
    assert not tpk.verify(ir, vk, _bump_pi(proof, len(prev_vk)),
                          STANDIN_MODE, device="cpu")


@pytest.mark.slow
def test_compression_setups_verify_the_golden_chain(standin, one_thread):
    """The port's setup of every mode gives the golden VK; the layer's
    verify accepts the golden proof and refuses it with one public input
    changed or another inner VK expected (about a minute on a CPU)."""
    for mode in range(1, 6):
        ir, cfg, vk = standin[mode]
        cs = tly.create_compression_layer_setup_data(
            mode, ir, cfg, STANDIN_MODE, device="cpu")
        assert cs.sd.vk == _load(f"wrap_standin_mode{mode}_vk.json")
        proof = convert.proof_from_json(_load(f"wrap_standin_mode{mode}_"
                                              "proof.json"))
        args = (mode, ir, cfg)
        assert tly.verify_compression_layer_proof(
            *args, proof, expected_inner_vk=vk, outer_cfg=STANDIN_MODE,
            device="cpu")
        assert not tly.verify_compression_layer_proof(
            *args, _bump_pi(proof, len(vk)), outer_cfg=STANDIN_MODE,
            device="cpu")
        assert not tly.verify_compression_layer_proof(
            *args, proof, expected_inner_vk=[v + 1 for v in vk],
            outer_cfg=STANDIN_MODE, device="cpu")


@pytest.mark.slow
def test_five_mode_chain_proves_the_golden_bytes(one_thread):
    """The stand-in scheduler and the five modes of tests/test_compression.py
    proved on the CPU equal the JAX package's proofs and VKs, byte for
    byte; a tampered mode-5 proof fails `verify_fn`."""
    ir = tqc.queue_ir(5)
    setup = tqc.queue_setup(ir, STANDIN_SCHED, device="cpu")
    W = tqc.queue_witness(ir, [[i + 1 for i in range(8)]], device="cpu")
    sched = tpk.prove(ir, setup, W, STANDIN_SCHED, device="cpu")
    assert setup.vk() == _load("wrap_standin_scheduler_vk.json")
    assert _proof_json(sched) == _load("wrap_standin_scheduler_proof.json")
    chain = tly.CompressionChain(ir, STANDIN_SCHED, setup.vk(),
                                 outer_cfgs={m: STANDIN_MODE
                                             for m in range(1, 6)},
                                 device="cpu")
    src = InMemoryDataSource()
    out = tcp.wrap_proof(sched, sched.public_inputs[:4],
                         tcp.WrapperConfig(5), chain.prove_fn,
                         chain.verify_fn, src)
    for mode in range(1, 6):
        proof = (src.get_compression_proof(mode) if mode < 5
                 else out["final_proof"])
        assert _proof_json(proof) == _load(f"wrap_standin_mode{mode}_"
                                           "proof.json")
        assert [int(v) for v in chain.final_shape(mode)[2]] == \
            _load(f"wrap_standin_mode{mode}_vk.json")
        assert chain.stats[mode]["log_n"] == (11 if mode == 1 else 12)
    assert not chain.verify_fn(5, _bump_pi(out["final_proof"]), None)


def _golden_scheduler():
    """The golden tower's scheduler circuit, re-synthesized in the port."""
    from zkevm_harness_tpu_torch.circuits import leaf_circuit as tlc
    from zkevm_harness_tpu_torch.circuits import node_circuit as tnc
    from zkevm_harness_tpu_torch.circuits import scheduler_circuit as tsc
    from zkevm_harness_tpu_torch.circuits.types import testing_geometry
    cfg = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    with tly.engine_override(cfg):
        sd = tly.base_setup_for_type(8, testing_geometry(), device="cpu")
    leaf_b, _ = tlc.synthesize_leaf(sd.ir, cfg, 2, 8)
    node_b, _ = tnc.synthesize_node(leaf_b.finalize().ir, cfg, 1)
    aux = _load("tower_golden_summary.json")["scheduler_witness"][
        "aux_values"]
    sb, _ = tsc.synthesize_scheduler_multi([(node_b.finalize().ir, cfg)],
                                           (8,), aux_len=len(aux))
    return sb.finalize().ir, cfg, _load("tower_golden_scheduler_vk.json")


def test_golden_mode1_binds_the_golden_scheduler():
    """Mode 1 at LDE 32 over the golden tower's scheduler (the committed
    JAX proof): its public inputs are the scheduler's VK and public inputs,
    its FRI parameters mode 1's production ones."""
    proof = convert.proof_from_json(_load("wrap_mode1_proof.json"))
    sched = convert.proof_from_json(_load(
        "tower_golden_scheduler_proof.json"))
    vk = _load("tower_golden_scheduler_vk.json")
    assert [int(v) for v in proof.public_inputs] == \
        vk + [int(v) for v in sched.public_inputs]
    assert [int(v) for v in sched.public_inputs] == GOLDEN_PI
    cfg = tly.compression_engine_config(1)
    assert len(proof.witness_cap) == cfg.cap_size == 16


def test_golden_blob_chain_mode1_and_snark_bind_its_scheduler():
    """The JAX full chain with a blob in the scheduler's blob slot: its
    mode-1 proof's public inputs are that scheduler's VK and public inputs;
    the port's "pi" wrapper over that scheduler's public inputs gives the
    golden SNARK proof byte for byte, which verifies and packs them."""
    summary = _load("wrap_blob_summary.json")
    pi = summary["scheduler_pi"]
    proof = convert.proof_from_json(_load("wrap_blob_mode1_proof.json"))
    sched = convert.proof_from_json(_load("wrap_blob_scheduler_proof.json"))
    assert [int(v) for v in sched.public_inputs] == pi != GOLDEN_PI
    assert [int(v) for v in proof.public_inputs] == \
        _load("wrap_blob_scheduler_vk.json") + pi
    setup = tsw.wrapper_setup()
    snark = tsw.wrap_scheduler_pi(setup, pi)
    assert convert.json_roundtrip(convert.plonk_proof_to_json(snark)) == \
        _load("wrap_blob_snark_pi_proof.json")
    assert tsw.verify_wrapped_proof(setup.vk, snark,
                                    expected_scheduler_pi=pi)
    assert str(snark.public_inputs[-1]) == summary["snark_public_input"] \
        == str(tcp.compress_stark_pi_to_snark_pi(pi))


@pytest.mark.slow
def test_mode1_lde32_over_the_golden_scheduler_proves_the_golden_bytes():
    ir, cfg, vk = _golden_scheduler()
    sched = convert.proof_from_json(_load(
        "tower_golden_scheduler_proof.json"))
    chain = tly.CompressionChain(ir, cfg, vk, device="cpu")
    out = tcp.wrap_proof(sched, GOLDEN_PI, tcp.WrapperConfig(1),
                         chain.prove_fn, chain.verify_fn)
    assert _proof_json(out["final_proof"]) == _load("wrap_mode1_proof.json")
    assert [int(v) for v in out["final_vk"]] == _load("wrap_mode1_vk.json")
    assert not chain.verify_fn(1, _bump_pi(out["final_proof"]), None)


# -- BN254 ------------------------------------------------------------------

def _g1(mod, k):
    return mod.g1_mul(mod.G1_GENERATOR, k)


def test_bn254_group_laws_equal_to_jax():
    rng = random.Random(254)
    a, b = rng.randrange(tbn.R), rng.randrange(tbn.R)
    for mod in (tbn, jbn):
        assert mod.g1_add(_g1(mod, a), _g1(mod, b)) == _g1(mod, a + b)
        assert mod.g1_add(_g1(mod, a), mod.g1_neg(_g1(mod, a))) is None
        assert mod.g1_mul(mod.G1_GENERATOR, mod.R) is None
        assert mod.g2_add(mod.g2_mul(mod.G2_GENERATOR, a),
                          mod.g2_mul(mod.G2_GENERATOR, b)) == \
            mod.g2_mul(mod.G2_GENERATOR, a + b)
    assert _g1(tbn, a) == _g1(jbn, a)
    assert tbn.g2_mul(tbn.G2_GENERATOR, b) == jbn.g2_mul(jbn.G2_GENERATOR, b)
    assert tbn.g1_is_on_curve(_g1(tbn, a))
    assert tbn.g2_is_on_curve(tbn.g2_mul(tbn.G2_GENERATOR, b))


def test_bn254_msm_native_python_and_naive_sum_agree(monkeypatch):
    rng = random.Random(1)
    pts = [_g1(tbn, rng.randrange(1, tbn.R)) for _ in range(8)] + [None]
    sc = [rng.randrange(tbn.R) for _ in range(9)]
    naive = None
    for p, s in zip(pts, sc):
        naive = tbn.g1_add(naive, tbn.g1_mul(p, s) if p else None)
    before = native.MSM_CALLS["bn254_msm"]
    assert tbn.g1_msm(pts, sc) == naive == jbn.g1_msm(pts, sc)
    assert native.MSM_CALLS["bn254_msm"] == before + 1

    def unavailable(*_a):
        raise RuntimeError("native bn254_msm unavailable")

    monkeypatch.setattr(native, "bn254_msm", unavailable)
    assert tbn.g1_msm(pts, sc) == naive   # the Python Pippenger


def test_bn254_fft_and_kate_equal_to_jax():
    rng = random.Random(2)
    poly = [rng.randrange(tbn.R) for _ in range(16)]
    assert tbn.fr_fft(poly) == jbn.fr_fft(poly)
    assert tpl.fr_ifft(tbn.fr_fft(poly)) == poly
    crs = tbn.simulated_crs(17)
    assert crs == jbn.simulated_crs(17)
    z = rng.randrange(tbn.R)
    w, y = tbn.kate_open(crs, poly, z)
    assert (w, y) == jbn.kate_open(crs, poly, z)
    assert y == tpl.poly_eval(poly, z)
    c = tbn.kate_commit(crs, poly)
    g2 = tbn.simulated_crs_g2()
    assert tbn.kate_verify(g2, c, z, y, w)
    assert not tbn.kate_verify(g2, c, z, (y + 1) % tbn.R, w)


def test_bn254_pairing_is_bilinear_and_equal_to_jax():
    a, b = 5, 7
    t = tbn.pairing(_g1(tbn, a), tbn.g2_mul(tbn.G2_GENERATOR, b))
    assert t == tbn.pairing(_g1(tbn, a * b), tbn.G2_GENERATOR)
    assert t == jbn.pairing(_g1(jbn, a), jbn.g2_mul(jbn.G2_GENERATOR, b))
    assert t != tbn.pairing(_g1(tbn, a * b + 1), tbn.G2_GENERATOR)


# -- the "pi" SNARK wrapper ---------------------------------------------------

@pytest.fixture(scope="module")
def snark():
    setup = tsw.wrapper_setup()
    return setup, tsw.wrap_scheduler_pi(setup, GOLDEN_PI)


def test_snark_pi_vk_and_proof_equal_the_golden_bytes(snark):
    setup, proof = snark
    assert convert.json_roundtrip(convert.plonk_vk_to_json(setup.vk)) == \
        _load("wrap_snark_pi_vk.json")
    assert convert.json_roundtrip(convert.plonk_proof_to_json(proof)) == \
        _load("wrap_snark_pi_proof.json")
    assert tsw.verify_wrapped_proof(setup.vk, proof,
                                    expected_scheduler_pi=GOLDEN_PI)
    assert proof.public_inputs[-1] == \
        tcp.compress_stark_pi_to_snark_pi(GOLDEN_PI)
    golden_vk = convert.plonk_vk_from_json(_load("wrap_snark_pi_vk.json"))
    golden_proof = convert.plonk_proof_from_json(
        _load("wrap_snark_pi_proof.json"))
    assert tsw.verify_wrapped_proof(golden_vk, golden_proof,
                                    expected_scheduler_pi=GOLDEN_PI)


def _tamper(proof, what):
    p = dataclasses.replace(proof, comms=dict(proof.comms),
                            evals=dict(proof.evals),
                            public_inputs=list(proof.public_inputs))
    if what == "pi":
        return p, [v + 1 for v in GOLDEN_PI]
    if what == "packed":
        p.public_inputs[-1] = (p.public_inputs[-1] + 1) % tbn.R
    elif what == "evaluation":
        p.evals["a"] = (p.evals["a"] + 1) % tbn.R
    elif what == "commitment":
        p.comms["z"] = tbn.g1_add(p.comms["z"], tbn.G1_GENERATOR)
    return p, GOLDEN_PI


@pytest.mark.parametrize("what", ("pi", "packed", "evaluation",
                                  "commitment"))
def test_snark_pi_rejects_a_tampered_proof(snark, what):
    setup, proof = snark
    bad, expected = _tamper(proof, what)
    assert tsw.verify_wrapped_proof(setup.vk, bad,
                                    expected_scheduler_pi=expected) is False


# -- the full chain -----------------------------------------------------------

@pytest.mark.slow
def test_full_chain_over_the_golden_tower_block_equals_the_goldens():
    """`full_chain.prove_block_full_chain` over the golden tower's block
    and config (no blob): its scheduler proof is the golden tower's, its
    mode-1 proof (production config, LDE 32) and SNARK public input the
    golden chain's, and every link verifies."""
    from zkevm_harness_tpu_torch import full_chain as tfc
    from zkevm_harness_tpu_torch.vm import isa
    cfg = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    chain = tfc.prove_block_full_chain(
        golden.tower_block(isa), chain_types=(8,), base_cfg=cfg,
        recursion_cfg=cfg, device="cpu")
    assert _proof_json(chain.scheduler.proof) == \
        _load("tower_golden_scheduler_proof.json")
    assert chain.scheduler_pi == GOLDEN_PI
    assert _proof_json(chain.final["final_proof"]) == \
        _load("wrap_mode1_proof.json")
    assert chain.final["snark_public_input"] == \
        tcp.compress_stark_pi_to_snark_pi(GOLDEN_PI)
    assert convert.json_roundtrip(convert.plonk_proof_to_json(
        chain.snark["proof"])) == _load("wrap_snark_pi_proof.json")
    assert set(chain.stats) == {"compression_1", "snark"}
    assert chain.stats["compression_1"]["verify_s"] > 0


@pytest.mark.slow
def test_full_chain_with_a_blob_equals_the_goldens():
    """The same chain with the JAX tests' blob (496 bytes, KZG testing
    domain 16) in the scheduler's blob slot: its blob proof, scheduler,
    mode-1 and SNARK proofs equal the JAX package's full chain's
    (tools/gen_wrap_golden.py, stage `chain`)."""
    from zkevm_harness_tpu_torch import full_chain as tfc
    from zkevm_harness_tpu_torch.utils import kzg as tkzg
    from zkevm_harness_tpu_torch.vm import isa
    cfg = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    blob = bytes.fromhex(_load("eip4844_golden.json")["blob"])
    chain = tfc.prove_block_full_chain(
        golden.tower_block(isa), chain_types=(8,), base_cfg=cfg,
        recursion_cfg=cfg, blobs=[blob],
        blob_kzg_settings=tkzg.KzgSettings.testing(16), device="cpu")
    summary = _load("wrap_blob_summary.json")
    assert _proof_json(chain.eip4844[0]["proof"]) == \
        _load("eip4844_n16_proof.json")
    assert chain.stats["eip4844_0"]["config"] == dataclasses.asdict(cfg)
    assert [int(v) for v in chain.scheduler.vk] == \
        _load("wrap_blob_scheduler_vk.json")
    assert _proof_json(chain.scheduler.proof) == \
        _load("wrap_blob_scheduler_proof.json")
    assert chain.scheduler_pi == summary["scheduler_pi"]
    assert [int(v) for v in chain.final["final_vk"]] == \
        _load("wrap_blob_mode1_vk.json")
    assert _proof_json(chain.final["final_proof"]) == \
        _load("wrap_blob_mode1_proof.json")
    assert convert.json_roundtrip(convert.plonk_proof_to_json(
        chain.snark["proof"])) == _load("wrap_blob_snark_pi_proof.json")
    assert set(chain.stats) == {"eip4844_0", "compression_1", "snark"}
