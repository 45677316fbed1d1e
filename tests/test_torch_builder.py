"""The port's circuit builder (`circuits/builder.py`) against the JAX
package's, bit for bit (integers, tolerance 0), on one seeded random
program of adds, muls, linear terms, constants, hints, bits, muxes, asserts
and Poseidon2 calls: the gate list, the permutations and the public-input
variables; the const columns and the copy wiring (against the JAX dense
permutation); `eval_values`, `fill_witness` and `public_values`; the IR's
metadata and its gate values on random rows, on the list path and on the
stacked device path. The port's `check_satisfied` accepts the witness and
rejects one flipped cell. Builder synthesis in the JAX package is plain
Python; no JAX proof or setup runs here.
"""

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.circuits import builder as jbd
from zkevm_harness_tpu.prover import satisfy as jsat
from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.circuits import builder as tbd
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import satisfy as tsat
from zkevm_harness_tpu_torch.prover.stark import DeviceAlgebra

P = tgl.P
SEED = 7


def random_program(bd, seed=SEED, steps=400, slots=8):
    """The same program on either package's builder module: (builder,
    assignments). Every op kind of the builder, Poseidon2 calls on earlier
    variables, outputs marked public."""
    rng = np.random.default_rng(seed)
    b = bd.CircuitBuilder(slots=slots)
    ins = b.inputs(6)
    asg = {v: int(x) for v, x in zip(ins, rng.integers(1, P, size=6,
                                                         dtype=np.uint64))}
    ext = bd.ExtOps(b)
    pool = list(ins) + [b.constant(int(rng.integers(0, 1 << 40)))]
    for _ in range(steps):
        x, y, z = (pool[int(i)] for i in rng.integers(0, len(pool), 3))
        k = int(rng.integers(0, 12))
        c = int(rng.integers(0, P, dtype=np.uint64))
        if k == 0:
            pool.append(b.add(x, y))
        elif k == 1:
            pool.append(b.sub(x, y))
        elif k == 2:
            pool.append(b.mul(x, y))
        elif k == 3:
            pool.append(b.lin(c, x, 3, y, c=5))
        elif k == 4:
            pool.append(b.lin(c, x))
        elif k == 5:
            pool.append(b.mul_add(x, y, z))
        elif k == 6:
            bit = b.bit(lambda v: int(v) & 1, (x,))
            pool.append(b.mux(bit, y, z))
        elif k == 7:
            pool.append(b.inverse(b.add_int(b.mul(x, x), 1)))
        elif k == 8:
            pool.extend(b.poseidon2([pool[int(i)] for i in
                                     rng.integers(0, len(pool), 12)]))
        elif k == 9:
            pool.append(b.constant(c))
        elif k == 10:
            e = ext.mul((x, y), ext.inverse((b.add_int(z, 3), x)))
            pool.extend(e)
        else:
            w = b.mul(x, y)
            b.assert_mul(x, y, w)
            b.assert_eq(w, b.mul(y, x))
            pool.append(w)
    b.assert_bool(b.constant(1))
    b.assert_zero(b.sub(pool[-1], pool[-1]))
    for v in pool[-5:] + ins[:2]:
        b.mark_public(v)
    return b, asg


@pytest.fixture(scope="module")
def rigs():
    jb, jasg = random_program(jbd)
    tb, tasg = random_program(tbd)
    assert jasg == tasg
    return (jb, jb.finalize(max_width=48), tb, tb.finalize(max_width=48),
            tasg)


def test_gates_permutations_and_public_vars(rigs):
    jb, _, tb, _, _ = rigs
    jq, jw = convert.builder_gates(jb)
    tq, tw = convert.builder_gates(tb)
    assert jq.shape[0] > 1000 and len(tb.perms) > 20
    assert np.array_equal(jq, tq) and np.array_equal(jw, tw)
    assert tb.perms == jb.perms
    assert tb.pi_vars == jb.pi_vars and tb.n_vars == jb.n_vars


def test_const_columns_wiring_and_ir_metadata(rigs):
    _, jbuilt, tb, tbuilt, _ = rigs
    jc, jwiring = convert.built_circuit_arrays(jbuilt)
    tc, twiring = convert.built_circuit_arrays(tbuilt)
    assert tc.dtype == np.uint64 and np.array_equal(jc, tc)
    assert len(twiring.cells) > 1000
    assert np.array_equal(jwiring.cells, twiring.cells)
    assert np.array_equal(jwiring.succ, twiring.succ)
    ji, ti = jbuilt.ir, tbuilt.ir
    assert tb.tiles >= 2  # more than one Poseidon2 tile
    for f in ("log_n", "num_witness", "num_const", "gate_degree",
              "num_gate_constraints", "copy_chunk", "public_input_cells",
              "gate_part_counts", "gate_part_degrees", "gate_part_cols"):
        assert getattr(ti, f) == getattr(ji, f), f


def test_values_witness_and_public_values(rigs):
    jb, _, tb, _, asg = rigs
    vals = tb.eval_values(asg, device="cpu")
    assert vals == [int(v) for v in jb.eval_values(asg)]
    assert tb.public_values(asg, device="cpu") == \
        [int(v) for v in jb.public_values(asg)]
    jW = jb.fill_witness(asg)
    tW = tb.fill_witness(asg, device="cpu")
    assert np.array_equal(convert.pairs_to_u64(jW.lo, jW.hi),
                          tgl.to_u64(tW))
    assert tbd.perm_trace_host(list(range(12))).tolist() == \
        [[int(x) for x in r] for r in jbd.perm_trace_host(list(range(12)))]


def test_gate_values_on_random_rows(rigs):
    _, jbuilt, _, tbuilt, _ = rigs
    ir, n = tbuilt.ir, 1 << tbuilt.ir.log_n
    rng = np.random.default_rng(3)
    W = rng.integers(0, P, size=(ir.num_witness, n), dtype=np.uint64)
    C = rng.integers(0, P, size=(ir.num_const, n), dtype=np.uint64)
    Wo, Co = W.astype(object), C.astype(object)
    w = [Wo[c] for c in range(ir.num_witness)]
    wn = [np.roll(Wo[c], -1) for c in range(ir.num_witness)]
    c = [Co[j] for j in range(ir.num_const)]
    want = [np.asarray(v, dtype=object) % P for v in
            jbuilt.ir.eval_gates(jsat.HostNpAlgebra(), w, wn, c)]
    host = tbuilt.ir.eval_gates(tsat.HostNpAlgebra(), w, wn, c)
    assert len(host) == len(want) == ir.num_gate_constraints
    for a, b in zip(host, want):
        assert np.array_equal(np.asarray(a, dtype=object) % P, b)
    # the stacked device path, part by part, on CPU tensors
    Wt, Ct = tgl.from_u64(W, "cpu"), tgl.from_u64(C, "cpu")
    wt = [Wt[k] for k in range(ir.num_witness)]
    wnt = [torch.roll(Wt[k], -1) for k in range(ir.num_witness)]
    ct = [Ct[j] for j in range(ir.num_const)]
    dev = []
    for part in ir.eval_gates_parts:
        dev += part(DeviceAlgebra(), wt, wnt, ct)
    assert len(dev) == len(want)
    for a, b in zip(dev, want):
        assert np.array_equal(tgl.to_u64(a).astype(object), b)


def test_check_satisfied_accepts_and_rejects_a_flipped_cell(rigs):
    jb, _, tb, tbuilt, asg = rigs
    W = tgl.to_u64(tb.fill_witness(asg, device="cpu")).astype(object)
    pis = tb.public_values(asg, device="cpu")
    args = (tbuilt.ir, W, tbuilt.const_cols.astype(object), tbuilt.wiring)
    assert tsat.check_satisfied(*args, public_inputs=pis) == []
    vals = tb.eval_values(asg, device="cpu")
    assert len(tb.unsatisfied_gates(vals, device="cpu")) == 0
    bad = W.copy()
    bad[0, 0] = (bad[0, 0] + 1) % P  # the first constant gate's wire
    assert tsat.check_satisfied(tbuilt.ir, bad, *args[2:],
                                public_inputs=pis)
    _, wires = tb.gate_arrays()
    var = int(wires[0, 1])
    vals[var] = (vals[var] + 1) % P
    assert len(tb.unsatisfied_gates(vals, device="cpu")) > 0
