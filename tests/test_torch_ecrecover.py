"""The port's ecrecover circuit (type 7) — the foreign-field row core
(`circuits/ffarith.py`), the recovery program (`circuits/ecrecover_circuit.py`),
its decomposer (`witness/ecrecover_witness.py`), the exact host check
(`prover/satisfy.py`) and the typed layer functions — held against the JAX
package and the committed golden artifacts (`tools/gen_block_golden.py`),
bit for bit (tolerance 0).

Tier-1 tests stay cheap: the toy curve of the golden instance (61-bit
field, 64-bit scalars, u8 limbs: 70 columns at 2^14 rows), host Python and
numpy on both sides, and one setup's VK (99 columns committed at 2^15
through the CPU's plain kernels, about 10 s). The golden proof through the
port's prover on the CPU and the full-size secp256k1 witness are `slow`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.circuits import ecrecover_circuit as jec
from zkevm_harness_tpu.circuits import ffarith as jff
from zkevm_harness_tpu.prover import layers as jly
from zkevm_harness_tpu.witness import ecrecover_witness as jew
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import ecrecover_circuit as tec
from zkevm_harness_tpu_torch.circuits import ffarith as tff
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover import satisfy
from zkevm_harness_tpu_torch.prover.stark import (DeviceAlgebra,
                                                  HostExtAlgebra)
from zkevm_harness_tpu_torch.utils import secp256k1 as ec
from zkevm_harness_tpu_torch.utils import serde
from zkevm_harness_tpu_torch.witness import ecrecover_witness as tew

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CFG = tpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _u64(gf):
    """A JAX field array as uint64."""
    return np.asarray(gf.lo).astype(np.uint64) | \
        (np.asarray(gf.hi).astype(np.uint64) << np.uint64(32))


def dense_wiring(perm):
    """The JAX dense permutation's moved cells and successors, sorted."""
    w = convert.copy_wiring_from_dense(perm)
    order = np.argsort(w.cells)
    return w.cells[order], w.succ[order]


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


@pytest.fixture(scope="module")
def toy():
    curve = golden.ecrecover_toy_curve()
    tp = tec.build_ecrecover_program(tec.CurveParams(**curve))
    jp = jec.build_ecrecover_program(jec.CurveParams(**curve))
    return tp, jp, golden.ecrecover_toy_signature()


@pytest.mark.parametrize("limb_bits,num_limbs", [(8, 8), (8, 32), (16, 16)])
def test_ffparams_split_join(limb_bits, num_limbs):
    rng = np.random.default_rng(limb_bits * num_limbs)
    bits = limb_bits * num_limbs
    values = [int.from_bytes(rng.bytes(bits // 8), "little")
              for _ in range(20)] + [0, (1 << bits) - 1]
    tp = tff.FFParams(modulus=(1 << bits) - 1, limb_bits=limb_bits,
                      num_limbs=num_limbs)
    jp = jff.FFParams(modulus=(1 << bits) - 1, limb_bits=limb_bits,
                      num_limbs=num_limbs)
    assert tp.shift == jp.shift
    many = tp.split_many(values)
    for v, row in zip(values, many):
        assert tp.split(v) == jp.split(v) == [int(x) for x in row]
        assert tp.join(tp.split(v)) == jp.join(jp.split(v)) == v


def test_ir_metadata_equal(toy):
    tp, jp, _sig = toy
    tl, jl = tp.layout, jp.layout
    assert (tl.log_n, tl.num_rows, tl.pi_cells, tl.bind_c) == \
        (jl.log_n, jl.num_rows, jl.pi_cells, jl.bind_c)
    tir = tff.layout_ir(tl)
    jir = jff.ff_ir(jl.params, jl.log_n, jl.num_rows)
    for f in ("log_n", "num_witness", "num_const", "gate_degree",
              "num_gate_constraints", "copy_chunk", "lookup_sets"):
        assert getattr(tir, f) == getattr(jir, f), f
    assert tir.public_input_cells == jl.pi_cells
    assert np.array_equal(np.asarray(tir.lookup_tables[0], dtype=object),
                          np.asarray(jir.lookup_tables[0], dtype=object))
    assert (tp.h_row, tp.r_row, tp.s_row, tp.qx_row, tp.qy_row, tp.ry_row,
            tp.h_bits, tp.r_bits, tp.s_bits) == \
        (jp.h_row, jp.r_row, jp.s_row, jp.qx_row, jp.qy_row, jp.ry_row,
         jp.h_bits, jp.r_bits, jp.s_bits)


def test_const_rows_equal(toy):
    tp, jp, _sig = toy
    want = np.asarray(jp.layout.const_rows, dtype=object).astype(np.uint64)
    assert np.array_equal(tp.layout.const_rows, want)


def test_copy_wiring_equals_the_dense_permutation(toy):
    """The port's wiring moves the cells the JAX package's dense
    permutation moves, each to the same successor."""
    tp, jp, _sig = toy
    cells, succ = dense_wiring(jp.layout.permutation)
    assert len(cells) > 100_000
    assert np.array_equal(tp.layout.wiring.cells, cells)
    assert np.array_equal(tp.layout.wiring.succ, succ)


@pytest.mark.parametrize("modulus,limb_bits,num_limbs,bind_c", [
    ((1 << 61) - 1, 8, 8, False), (ec.P, 8, 32, False),
    ((1 << 255) - 19, 16, 16, True)])
def test_gate_values_equal_on_random_rows(modulus, limb_bits, num_limbs,
                                          bind_c):
    """Random (non-limb) rows exercise every constraint as a polynomial: the
    stacked digits and pins of the device algebra and the host loop give the
    JAX package's values, in its order (the binding fingerprint too)."""
    tp = tff.FFParams(modulus, limb_bits, num_limbs)
    jp = jff.FFParams(modulus, limb_bits, num_limbs)
    gate_values_equal(tff.ff_ir(tp, 8, 100, bind_c),
                      jff.ff_ir(jp, 8, 100, bind_c))


def test_witness_equal_and_satisfied(toy):
    tp, jp, (h, r, s, q, ry) = toy
    tir = tff.layout_ir(tp.layout)
    jir = jff.ff_ir(jp.layout.params, jp.layout.log_n, jp.layout.num_rows)
    tW = tec.ecrecover_witness(tp, tir, h, r, s, q, ry, device="cpu")
    jW = jec.ecrecover_witness(jp, jir, h, r, s, q, ry)
    assert np.array_equal(tgl.to_u64(tW), _u64(jW))
    pis = tec.expected_public_inputs(tp, h, r, s, q)
    assert pis == jec.expected_public_inputs(jp, h, r, s, q)
    assert satisfy.check_satisfied(tir, tgl.to_u64(tW),
                                   tp.layout.const_rows.T, tp.layout.wiring,
                                   pis) == []
    assert tff.result_value(tp.layout, tW, tff.FFVar(tp.qx_row, "R")) == q[0]


def test_forged_key_fails_and_a_broken_copy_is_reported(toy):
    tp, _jp, (h, r, s, q, ry) = toy
    tir = tff.layout_ir(tp.layout)
    bad_q = golden.ecrecover_toy_signature()[3][::-1]
    with pytest.raises(AssertionError):
        tec.ecrecover_witness(tp, tir, h, r, s, bad_q, ry, device="cpu")
    W = tgl.to_u64(tec.ecrecover_witness(tp, tir, h, r, s, q, ry,
                                         device="cpu"))
    # wire the h and s input cells, which hold different values, together
    n = 1 << tir.log_n
    a, b = tp.h_row, n + tp.s_row  # limb 0 (A column 0), limb 1 (column 1)
    assert W.reshape(-1)[a] != W.reshape(-1)[b]
    bad = tpk.CopyWiring(np.array([a, b]), np.array([b, a]))
    out = satisfy.check_satisfied(tir, W, tp.layout.const_rows.T, bad)
    assert out and all(v.startswith("copy") for v in out)


def test_vk_equals_the_golden(toy):
    tp, _jp, _sig = toy
    ir, setup = tff.ff_setup(tp.layout, CFG, device="cpu")
    assert setup.vk() == _load("ecrecover_toy_vk.json")


def test_lift_r_point_equals_jax():
    for i in range(4):
        msg = bytes([i]) * 32
        v, r, s = ec.sign(msg, 0xC0FFEE + i, 0x5EED + 3 * i)
        for parity in (0, 1):
            y = tly._lift_r_point(r, parity)
            assert y == jly._lift_r_point(r, parity)
            assert y & 1 == parity and (y * y - r ** 3 - 7) % ec.P == 0


def test_decompose_signed_and_malformed_inputs():
    calls = golden.ecrecover_inputs(3)
    # malformed: r = 0, a v beyond 2^32, a forged s
    calls.append(calls[0][:64] + bytes(32) + calls[0][96:])
    calls.append(calls[0][:32] + (1 << 40).to_bytes(32, "big") + calls[0][64:])
    calls.append(calls[1][:96] + (5).to_bytes(32, "big"))
    for cap in (1, 2, 7):
        got, want = tew.ecrecover_decompose(calls, cap), \
            jew.ecrecover_decompose(calls, cap)
        assert [dataclasses.astuple(w) for w in got] == \
            [dataclasses.astuple(w) for w in want]
    invs = tew.ecrecover_decompose(calls, 7)[0].invocations
    assert [i.success for i in invs] == [True] * 3 + [False, False, True]
    assert invs[5].recovered_point != invs[1].recovered_point
    assert tew.ecrecover_decompose([], 7) == []


def test_production_ecrecover_pis_equal_jax():
    """The expected public inputs of a real invocation through the typed
    surface (the production program, secp256k1 at u8 limbs)."""
    inv = tew.ecrecover_decompose(golden.ecrecover_inputs(1), 7)[0]
    jinv = jew.ecrecover_decompose(golden.ecrecover_inputs(1), 7)[0]
    assert tly.real_base_instance_public_inputs(7, inv, None, 7) == \
        jly.real_base_instance_public_inputs(7, jinv, None, 7)
    tl, jl = tly._ecrecover_program().layout, jly._ecrecover_program().layout
    assert (tl.log_n, tl.num_rows, tl.pi_cells) == \
        (jl.log_n, jl.num_rows, jl.pi_cells)
    assert tff.layout_ir(tl).num_witness == 286


@pytest.mark.slow
def test_golden_proof_on_the_cpu(toy):
    tp, _jp, (h, r, s, q, ry) = toy
    ir, setup = tff.ff_setup(tp.layout, CFG, device="cpu")
    W = tec.ecrecover_witness(tp, ir, h, r, s, q, ry, device="cpu")
    proof = tpk.prove(ir, setup, W, CFG, device="cpu")
    assert json.loads(json.dumps(serde.proof_to_json(proof))) == \
        _load("ecrecover_toy_proof.json")
    assert tpk.verify(ir, setup.vk(), proof, CFG, device="cpu")


@pytest.mark.slow
def test_secp256k1_full_size_witness_satisfied_and_equal():
    """The production program on a real signature: the port's witness
    equals the JAX package's and satisfies every constraint exactly, and
    the copy wiring equals the JAX dense permutation."""
    inv = tew.ecrecover_decompose(golden.ecrecover_inputs(1), 7)[0] \
        .invocations[0]
    tp, jp = tly._ecrecover_program(), jly._ecrecover_program()
    h, r, s = tly._ecrecover_scalars(inv)
    ry = tly._lift_r_point(inv.r, inv.v)
    tir = tff.layout_ir(tp.layout)
    jir = jff.ff_ir(jp.layout.params, jp.layout.log_n, jp.layout.num_rows)
    tW = tec.ecrecover_witness(tp, tir, h, r, s, inv.recovered_point, ry,
                               device="cpu")
    jW = jec.ecrecover_witness(jp, jir, h, r, s, inv.recovered_point, ry)
    assert np.array_equal(tgl.to_u64(tW), _u64(jW))
    cells, succ = dense_wiring(jp.layout.permutation)
    assert np.array_equal(tp.layout.wiring.cells, cells)
    assert np.array_equal(tp.layout.wiring.succ, succ)
    assert np.array_equal(
        tp.layout.const_rows,
        np.asarray(jp.layout.const_rows, dtype=object).astype(np.uint64))
    pis = tec.expected_public_inputs(tp, h, r, s, inv.recovered_point)
    assert satisfy.check_satisfied(tir, tgl.to_u64(tW),
                                   tp.layout.const_rows.T, tp.layout.wiring,
                                   pis) == []
