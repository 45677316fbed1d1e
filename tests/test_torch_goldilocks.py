"""Port vs JAX package: Goldilocks field ops, bit for bit (tolerance 0).

The same numpy inputs, made from a seed, go through
`zkevm_harness_tpu.ops.goldilocks` and `zkevm_harness_tpu_torch.ops.goldilocks`
(on the CPU the port runs its kernels' plain versions).
"""

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.ops import pallas_kernels as pkn
from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
from zkevm_harness_tpu_torch.ops import goldilocks as tgl

P = jgl.P
EDGES = [0, 1, P - 1, P - 2, 0xFFFFFFFF, 1 << 32, (1 << 63), 7]


def _inputs(seed=0, n=256):
    rng = np.random.default_rng(seed)
    va = rng.integers(0, P, size=n, dtype=np.uint64)
    vb = rng.integers(0, P, size=n, dtype=np.uint64)
    pairs = [(a % P, b % P) for a in EDGES for b in EDGES]
    va[:len(pairs)] = [a for a, _ in pairs]
    vb[:len(pairs)] = [b for _, b in pairs]
    return va, vb


def _both(u):
    return jgl.from_u64(u), tgl.from_u64(u, "cpu")


def _same(jax_gf, torch_gf):
    return np.array_equal(jgl.to_u64(jax_gf), tgl.to_u64(torch_gf))


BINARY = {"add": (jgl.add, tgl.add), "sub": (jgl.sub, tgl.sub),
          "mul": (jgl.mul, tgl.mul)}
UNARY = {"neg": (jgl.neg, tgl.neg), "sqr": (jgl.sqr, tgl.sqr),
         "double": (jgl.double, tgl.double), "pow7": (jgl.pow7, tgl.pow7),
         "inv": (jgl.inv, tgl.inv),
         "pow_const_5": (lambda a: jgl.pow_const(a, 5),
                         lambda a: tgl.pow_const(a, 5)),
         "pow_const_0": (lambda a: jgl.pow_const(a, 0),
                         lambda a: tgl.pow_const(a, 0)),
         "pow_const_65537": (lambda a: jgl.pow_const(a, 65537),
                             lambda a: tgl.pow_const(a, 65537))}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_matches_jax(name):
    va, vb = _inputs()
    (ja, ta), (jb, tb) = _both(va), _both(vb)
    jf, tf = BINARY[name]
    assert _same(jf(ja, jb), tf(ta, tb))


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_matches_jax(name):
    va, _ = _inputs(seed=1, n=96)
    ja, ta = _both(va)
    jf, tf = UNARY[name]
    assert _same(jf(ja), tf(ta))


def test_ops_match_python_ints():
    va, vb = _inputs(seed=2)
    a, b = tgl.from_u64(va, "cpu"), tgl.from_u64(vb, "cpu")
    ia, ib = [int(v) for v in va], [int(v) for v in vb]
    assert list(tgl.to_ints(tgl.mul(a, b))) == [x * y % P
                                                for x, y in zip(ia, ib)]
    assert list(tgl.to_ints(tgl.add(a, b))) == [(x + y) % P
                                                for x, y in zip(ia, ib)]
    assert list(tgl.to_ints(tgl.sub(a, b))) == [(x - y) % P
                                                for x, y in zip(ia, ib)]
    assert list(tgl.to_ints(tgl.inv(a))) == [pow(x, P - 2, P) for x in ia]


def test_from_int_canonicalises():
    vals = [P, P + 5, (1 << 64) - 1, -1, 3 * P + 2, 0]
    got = tgl.to_ints(tgl.from_int(np.array(vals, dtype=object), "cpu"))
    assert [int(v) for v in got] == [v % P for v in vals]
    assert np.array_equal(jgl.to_u64(jgl.from_int(vals)),
                          tgl.to_u64(tgl.from_int(vals, "cpu")))
    assert int(tgl.to_ints(tgl.neg(tgl.from_int(0, "cpu")))) == 0


def _ext_inputs(seed):
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, P, size=64, dtype=np.uint64) for _ in range(4)]
    for p in parts:
        p[:len(EDGES)] = [e % P for e in EDGES]
    parts[1][:4] = 0  # base-field elements among the inputs
    ja = jgl.GF2(jgl.from_u64(parts[0]), jgl.from_u64(parts[1]))
    jb = jgl.GF2(jgl.from_u64(parts[2]), jgl.from_u64(parts[3]))
    ta = tgl.GF2(tgl.from_u64(parts[0], "cpu"), tgl.from_u64(parts[1], "cpu"))
    tb = tgl.GF2(tgl.from_u64(parts[2], "cpu"), tgl.from_u64(parts[3], "cpu"))
    return ja, jb, ta, tb


def _same_ext(j, t):
    return _same(j.c0, t.c0) and _same(j.c1, t.c1)


EXT_BINARY = {"ext_add": (jgl.ext_add, tgl.ext_add),
              "ext_sub": (jgl.ext_sub, tgl.ext_sub),
              "ext_mul": (jgl.ext_mul, tgl.ext_mul)}
EXT_UNARY = {"ext_neg": (jgl.ext_neg, tgl.ext_neg),
             "ext_sqr": (jgl.ext_sqr, tgl.ext_sqr),
             "ext_inv": (jgl.ext_inv, tgl.ext_inv),
             "ext_pow_const_11": (lambda a: jgl.ext_pow_const(a, 11),
                                  lambda a: tgl.ext_pow_const(a, 11))}


@pytest.mark.parametrize("name", sorted(EXT_BINARY))
def test_ext_binary_op_matches_jax(name):
    ja, jb, ta, tb = _ext_inputs(3)
    jf, tf = EXT_BINARY[name]
    assert _same_ext(jf(ja, jb), tf(ta, tb))


@pytest.mark.parametrize("name", sorted(EXT_UNARY))
def test_ext_unary_op_matches_jax(name):
    ja, _jb, ta, _tb = _ext_inputs(4)
    jf, tf = EXT_UNARY[name]
    assert _same_ext(jf(ja), tf(ta))


def test_ext_mul_base_and_sum_axis_match_jax():
    ja, jb, ta, tb = _ext_inputs(5)
    assert _same_ext(jgl.ext_mul_base(ja, jb.c0), tgl.ext_mul_base(ta, tb.c0))
    j2 = jgl.GF2(ja.c0.reshape(8, 8), ja.c1.reshape(8, 8))
    t2 = ta.reshape(8, 8)
    assert _same_ext(jgl.ext_sum_axis(j2, axis=-1),
                     tgl.ext_sum_axis(t2, axis=-1))
    assert _same(jgl.sum_axis(ja.c0[:7]), tgl.sum_axis(ta.c0[:7]))


def test_array_helpers_match_jax():
    from zkevm_harness_tpu.ops.poseidon2_params import M4
    vals = np.random.default_rng(9).integers(0, P, size=(6, 4),
                                             dtype=np.uint64)
    j, t = jgl.from_u64(vals), tgl.from_u64(vals, "cpu")
    assert _same(jgl.dot_const_matrix(M4, j), tgl.dot_const_matrix(M4, t))
    assert _same(jgl.full((2, 3), P + 4), tgl.full((2, 3), P + 4, "cpu"))
    assert _same(jgl.broadcast_to(j[0], (5, 4)), tgl.broadcast_to(t[0], (5, 4)))
    assert _same(jgl.take(j, np.array([4, 0, 4]), axis=0),
                 tgl.take(t, np.array([4, 0, 4]), axis=0))
    assert _same(jgl.take(j, np.array([[3, 1]]), axis=1),
                 tgl.take(t, np.array([[3, 1]]), axis=1))
    assert _same(jgl.concatenate([j, j], axis=1),
                 tgl.concatenate([t, t], axis=1))
    mask = vals[:, 0] % np.uint64(2) == 0
    assert _same(jgl.select(mask[:, None], j, jgl.neg(j)),
                 tgl.select(torch.from_numpy(mask)[:, None], t, tgl.neg(t)))
    assert bool(tgl.is_zero(tgl.zeros((3,), "cpu")).all())
    assert not bool(tgl.is_zero(tgl.ones((3,), "cpu")).any())
    ja, jb, ta, tb = _ext_inputs(10)
    assert np.array_equal(np.asarray(jgl.ext_equal(ja, jb)),
                          tgl.ext_equal(ta, tb).numpy())
    assert bool(tgl.ext_equal(ta, ta).all())
    m = torch.from_numpy(np.arange(64) % 3 == 0)
    assert _same_ext(jgl.ext_select(m.numpy(), ja, jb),
                     tgl.ext_select(m, ta, tb))
    assert _same_ext(jgl.ext_stack([ja, jb], axis=1),
                     tgl.ext_stack([ta, tb], axis=1))
    assert _same_ext(jgl.ext_from_base(ja.c0), tgl.ext_from_base(ta.c0))


def test_gl_mul_plain_matches_pallas_mul_interpret():
    """The plain version of the ported kernel against the Pallas kernel it
    replaces, run as the JAX tests run it on the CPU (interpret mode)."""
    rng = np.random.default_rng(0)
    n = 8 * 128 * 2
    va = rng.integers(0, P, size=n, dtype=np.uint64)
    vb = rng.integers(0, P, size=n, dtype=np.uint64)
    va[:8] = [e % P for e in EDGES]
    vb[:8] = [e % P for e in reversed(EDGES)]
    want = jgl.to_u64(pkn.pallas_mul(jgl.from_u64(va), jgl.from_u64(vb)))
    got = ck.gl_mul_plain(tgl.from_u64(va, "cpu"), tgl.from_u64(vb, "cpu"))
    assert np.array_equal(want, tgl.to_u64(got))


def test_broadcasting_matches_materialised():
    rng = np.random.default_rng(6)
    a = tgl.from_u64(rng.integers(0, P, size=(5, 7), dtype=np.uint64), "cpu")
    row = tgl.from_u64(rng.integers(0, P, size=(7,), dtype=np.uint64), "cpu")
    col = tgl.from_u64(rng.integers(0, P, size=(5, 1), dtype=np.uint64), "cpu")
    for op in (tgl.mul, tgl.add, tgl.sub):
        assert torch.equal(op(a, row), op(a, row.expand(5, 7).contiguous()))
        assert torch.equal(op(a, col), op(a, col.expand(5, 7).contiguous()))
        assert torch.equal(op(a, row[2]), op(a, row[2].expand(5, 7).contiguous()))


def test_operand_patterns_index_like_broadcast():
    """The (div, mod) pair the CUDA wrapper hands to a kernel addresses the
    same element as torch's broadcasting, for every shape the prover uses."""
    rng = np.random.default_rng(7)

    def check(t_shape, out_shape, expand=None):
        t = torch.from_numpy(rng.integers(0, 1 << 40, size=t_shape))
        if expand is not None:
            t = t.expand(expand)
        n = int(np.prod(out_shape))
        flat, div, mod = ck._operand(t, tuple(out_shape), n)
        i = torch.arange(n)
        got = flat.reshape(-1)[(i // div) % mod]
        assert torch.equal(got, t.expand(out_shape).reshape(-1))

    check((), (4, 6))
    check((6,), (4, 6))
    check((4, 1), (4, 6))
    check((4, 6), (4, 6))
    check((1, 6), (4, 6))
    check((3, 1, 5), (3, 4, 5))  # not one run: materialised
    check((2, 4, 6), (2, 4, 6))
    check((4, 6), (2, 4, 6))
    check((1,), (4, 6), expand=(6,))  # an expanded scalar
    check((4, 1), (4, 6), expand=(4, 6))  # an expanded column


def test_convert_round_trip():
    va, _ = _inputs(seed=8)
    j = jgl.from_u64(va)
    t = convert.tensor_from_pairs(np.asarray(j.lo), np.asarray(j.hi), "cpu")
    assert np.array_equal(tgl.to_u64(t), va)
    lo, hi = convert.pairs_from_tensor(t)
    assert lo.dtype == np.uint32 and hi.dtype == np.uint32
    assert np.array_equal(lo, np.asarray(j.lo))
    assert np.array_equal(hi, np.asarray(j.hi))
    assert np.array_equal(convert.pairs_to_u64(*convert.u64_to_pairs(va)), va)


def test_powers_tables_match_host_ints():
    w = tgl.primitive_root_of_unity(12)
    assert w == jgl.primitive_root_of_unity(12)
    tbl = tgl.to_ints(tgl.powers_dev_cached(w, 4096, mult=7, device="cpu"))
    assert int(tbl[0]) == 7 and int(tbl[4095]) == 7 * pow(w, 4095, P) % P
    assert np.array_equal(
        tgl.to_u64(tgl.powers_dev_cached(3, 3000, device="cpu")),
        jgl.powers_host(3, 3000))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tgl.from_int([1, 2, 3])
    with pytest.raises(RuntimeError):
        tgl.zeros((4,))
