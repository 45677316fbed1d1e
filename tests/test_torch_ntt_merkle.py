"""Port vs JAX package: NTT / LDE / OOD evaluation and Merkle trees, bit for
bit (tolerance 0), on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.ops import merkle as jmk
from zkevm_harness_tpu.ops import ntt as jnt
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.ops import merkle as tmk
from zkevm_harness_tpu_torch.ops import ntt as tnt

P = jgl.P


def _cols(log_n, batch=3, seed=0):
    rng = np.random.default_rng(seed + log_n)
    vals = rng.integers(0, P, size=(batch, 1 << log_n), dtype=np.uint64)
    vals[0, :4] = [0, 1, P - 1, P - 2]
    return vals


def _same(j, t):
    return np.array_equal(jgl.to_u64(j), tgl.to_u64(t))


@pytest.mark.parametrize("log_n", [3, 6, 10])
def test_ntt_and_intt_match_jax(log_n):
    vals = _cols(log_n)
    j, t = jgl.from_u64(vals), tgl.from_u64(vals, "cpu")
    assert _same(jnt.ntt(j), tnt.ntt(t))
    assert _same(jnt.intt(j), tnt.intt(t))
    assert torch.equal(tnt.intt(tnt.ntt(t)), t)


@pytest.mark.parametrize("log_n", [3, 6, 10])
def test_coset_lde_matches_jax(log_n):
    vals = _cols(log_n, batch=2, seed=7)
    j, t = jgl.from_u64(vals), tgl.from_u64(vals, "cpu")
    assert _same(jnt.coset_lde(j, 2), tnt.coset_lde(t, 2))
    # the streamed schedule's recompute half gives the same LDE
    assert torch.equal(tnt.lde_from_coeffs(tnt.intt(t), 2 << log_n),
                       tnt.coset_lde(t, 2))


def test_eval_poly_at_matches_host_ints():
    """log_n 6 against exact Horner evaluation (XLA:CPU takes ~20 s to
    compile the JAX function at this one size)."""
    from zkevm_harness_tpu_torch.utils import field_int as fi
    vals = _cols(6, batch=2, seed=11)
    z = (0x123456789ABCDEF % P, (P - 5))
    got = tnt.eval_poly_at(tgl.from_u64(vals, "cpu"),
                           tgl.ext_from_ints(z[0], z[1], "cpu"))
    for r in range(2):
        want = fi.eval_poly_ext([(int(c), 0) for c in vals[r]], z)
        assert (int(tgl.to_ints(got.c0)[r]), int(tgl.to_ints(got.c1)[r])) == want


@pytest.mark.parametrize("log_n", [3, 10])
def test_eval_poly_at_matches_jax(log_n):
    vals = _cols(log_n, batch=2, seed=11)
    z = (0x123456789ABCDEF % P, (P - 5))
    want = jnt.eval_poly_at(jgl.from_u64(vals), jgl.ext_from_ints(*z))
    got = tnt.eval_poly_at(tgl.from_u64(vals, "cpu"),
                           tgl.ext_from_ints(z[0], z[1], "cpu"))
    assert _same(want.c0, got.c0) and _same(want.c1, got.c1)


def test_ntt_of_one_row_and_of_a_view():
    vals = _cols(5, batch=4, seed=13)
    t = tgl.from_u64(vals, "cpu")
    full = tnt.ntt(t)
    assert torch.equal(tnt.ntt(t[2]), full[2])
    assert torch.equal(tnt.ntt(t.t().contiguous().t()), full)


def test_powers_and_scaling_match_jax():
    vals = _cols(6, batch=2, seed=17)
    assert _same(jnt.scale_by_powers(jgl.from_u64(vals), 7),
                 tnt.scale_by_powers(tgl.from_u64(vals, "cpu"), 7))
    b = 0xDEADBEEFCAFE % P
    assert _same(jnt.powers_device(jgl.from_int(b), 64),
                 tnt.powers_device(tgl.from_int(b, "cpu"), 64))
    x = (3, 5)
    want = jnt.ext_powers_device(jgl.ext_from_ints(*x), 32)
    got = tnt.ext_powers_device(tgl.ext_from_ints(3, 5, "cpu"), 32)
    assert _same(want.c0, got.c0) and _same(want.c1, got.c1)


# -- Merkle -----------------------------------------------------------------

N_LEAVES, LEAF_W, CAP = 8, 6, 2
IDX = np.array([0, 3, 5, 6], dtype=np.uint32)


def _rows():
    return np.random.default_rng(23).integers(
        0, P, size=(N_LEAVES, LEAF_W), dtype=np.uint64)


def test_commit_caps_and_levels_match_jax():
    rows = _rows()
    jt = jmk.build_tree(jmk.hash_leaves(jgl.from_u64(rows)), CAP)
    tt = tmk.commit(tgl.from_u64(rows, "cpu"), CAP)
    assert tt.depth == jt.depth == 2
    assert tt.cap.shape == (CAP, 4)
    for jl, tl in zip(jt.levels, tt.levels):
        assert _same(jl, tl)


def test_open_indices_and_verify_paths_match_jax():
    rows = _rows()
    jt = jmk.build_tree(jmk.hash_leaves(jgl.from_u64(rows)), CAP)
    tt = tmk.commit(tgl.from_u64(rows, "cpu"), CAP)
    jp = jmk.open_indices(jt, IDX)
    tp = tmk.open_indices(tt, IDX)
    assert tp.shape == (len(IDX), 2, 4)
    assert _same(jp, tp)
    leaves = tgl.take(tt.levels[0], IDX, axis=0)
    ok = tmk.verify_paths(leaves, IDX, tp, tt.cap, n_leaves=N_LEAVES,
                          cap_size=CAP)
    assert ok.dtype == torch.bool and bool(ok.all())
    want = jmk.verify_paths(jgl.take(jt.levels[0], np.asarray(IDX), axis=0),
                            IDX, jp, jt.cap, n_leaves=N_LEAVES, cap_size=CAP)
    assert np.array_equal(np.asarray(want), ok.numpy())
    # a wrong leaf fails everywhere
    assert not bool(tmk.verify_paths(leaves ^ 1, IDX, tp, tt.cap,
                                     n_leaves=N_LEAVES, cap_size=CAP).any())


def test_verify_paths_geometry_checks():
    rows = _rows()
    tt = tmk.commit(tgl.from_u64(rows, "cpu"), CAP)
    tp = tmk.open_indices(tt, IDX)
    leaves = tgl.take(tt.levels[0], IDX, axis=0)
    # proof-chosen depth, cap size or an out-of-range index must reject
    assert not bool(tmk.verify_paths(leaves, IDX, tp[:, :1], tt.cap,
                                     n_leaves=N_LEAVES, cap_size=CAP).any())
    assert not bool(tmk.verify_paths(leaves, IDX, tp, tt.cap[:1],
                                     n_leaves=N_LEAVES, cap_size=CAP).any())
    bad_idx = IDX.copy()
    bad_idx[0] = N_LEAVES
    assert not bool(tmk.verify_paths(leaves, bad_idx, tp, tt.cap,
                                     n_leaves=N_LEAVES, cap_size=CAP).any())


def test_cap_equals_leaves():
    rows = tgl.from_u64(_rows(), "cpu")
    digests = tmk.hash_leaves(rows)
    tree = tmk.build_tree(digests, N_LEAVES)
    assert tree.depth == 0
    idx = np.arange(N_LEAVES, dtype=np.uint32)
    paths = tmk.open_indices(tree, idx)
    assert paths.shape == (N_LEAVES, 0, 4)
    assert bool(tmk.verify_paths(digests, idx, paths, tree.cap).all())
