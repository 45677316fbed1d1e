"""The port's Poseidon2 over BN254 Fr — `utils/poseidon2_bn254.py`, the
plain versions of its card kernel (`ops/cuda_kernels.bn254_hash_rows`,
`bn254_hash_pairs`) and the for-wrapper hash backend
(`prover/hash_backend.py`) — held against the JAX package on the same
inputs, made from a numpy seed, value for value (integers, tolerance 0).
On the CPU the kernel's wrappers run their plain versions; the card holds
the kernel against them in chip_smoke.py.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.prover import hash_backend as jhb
from zkevm_harness_tpu.utils import poseidon2_bn254 as jp2b
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import hash_backend as thb
from zkevm_harness_tpu_torch.utils import poseidon2_bn254 as tp2b

FR = tp2b.FR
P = tgl.P
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _fr(rng, k):
    """k uniform Fr values from a numpy generator (four 64-bit words)."""
    words = rng.integers(0, 1 << 63, size=(k, 4), dtype=np.int64).tolist()
    return [sum(int(w) << (63 * j) for j, w in enumerate(ws)) % FR
            for ws in words]


def _gl(rng, shape):
    """Canonical Goldilocks values as a uint64 array, edge values mixed in."""
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    flat[:3] = [0, P - 1, 1 << 63][:flat.size]
    return v


def test_params_json_is_a_byte_identical_copy():
    port = tp2b.PARAMS_PATH
    jax_copy = os.path.join(REPO, "zkevm_harness_tpu", "params",
                            "poseidon2_bn254.json")
    assert os.path.dirname(port) != os.path.dirname(jax_copy)
    assert filecmp.cmp(port, jax_copy, shallow=False)
    assert tp2b.get_params_bn254() == jp2b.get_params_bn254()


def test_permutation_equal_to_jax():
    rng = np.random.default_rng(254)
    states = [[0, 0, 0], [FR - 1] * 3] + [_fr(rng, 3) for _ in range(6)]
    for s in states:
        assert tp2b.permute(s) == jp2b.permute(s)


@pytest.mark.parametrize("length", [0, 1, 2, 3, 5, 8])
def test_sponge_hash_equal_to_jax(length):
    vals = _fr(np.random.default_rng(length), length)
    assert tp2b.hash_elements(vals) == jp2b.hash_elements(vals)


def test_duplex_sponge_equal_to_jax():
    rng = np.random.default_rng(3)
    t, j = tp2b.SpongeBn254(), jp2b.SpongeBn254()
    for k in (3, 0, 1, 4):
        vals = _fr(rng, k)
        t.absorb(vals)
        j.absorb(vals)
        got = [t.squeeze() for _ in range(k + 1)]
        assert got == [j.squeeze() for _ in range(k + 1)]


def test_pack_row_equal_to_jax_and_refuses_non_canonical_values():
    row = _gl(np.random.default_rng(5), (7,)).tolist()
    assert thb.Bn254Backend.pack_row(row) == jhb.Bn254Backend.pack_row(row)
    with pytest.raises(AssertionError):
        tp2b.pack_goldilocks([P])


def test_limbs_round_trip():
    vals = [0, 1, FR - 1] + _fr(np.random.default_rng(6), 5)
    limbs = tp2b.to_limbs(vals)
    assert limbs.dtype == np.int64 and limbs.shape == (8, 4)
    assert tp2b.from_limbs(limbs) == vals


@pytest.mark.parametrize("width", [0, 1, 3, 4, 7])
def test_hash_rows_plain_equal_to_jax(width):
    """The kernel's plain version on a (w, k) column-major tensor: each
    row's digest is the JAX package's hash of that row."""
    rows = _gl(np.random.default_rng(width), (5, width))
    cols = torch.from_numpy(np.ascontiguousarray(rows.T).view(np.int64))
    got = tp2b.from_limbs(ck.bn254_hash_rows(cols).numpy())
    assert got == jhb.Bn254Backend().hash_rows(rows.astype(object))


def test_hash_pairs_plain_equal_to_jax():
    vals = _fr(np.random.default_rng(7), 6)
    got = ck.bn254_hash_pairs(torch.from_numpy(tp2b.to_limbs(vals)))
    assert tp2b.from_limbs(got.numpy()) == \
        [jp2b.hash_elements(vals[i:i + 2]) for i in (0, 2, 4)]
    with pytest.raises(ValueError):
        ck.bn254_hash_pairs(torch.zeros((3, 4), dtype=torch.int64))


@pytest.fixture(scope="module")
def trees():
    """The same (k, w) rows committed by both packages: the port from its
    column-major tensor on the CPU, the JAX package from host ints."""
    rows = _gl(np.random.default_rng(11), (32, 5))
    cols = torch.from_numpy(np.ascontiguousarray(rows.T).view(np.int64))
    tb = thb.Bn254Backend("cpu")
    return (rows, tb, tb.commit_rows(cols, 4),
            jhb.Bn254Backend().commit_rows(rows.astype(object), 4))


def test_commit_rows_equal_to_jax(trees):
    _rows, _tb, tt, jt = trees
    assert tt.depth == jt.depth == 3 and tt.cap_size == jt.cap_size == 4
    assert [tp2b.from_limbs(level.numpy()) for level in tt.levels] == \
        jt.levels
    assert tt.cap == jt.cap
    assert all(level.device.type == "cpu" and level.dtype == torch.int64
               for level in tt.levels)


def test_open_and_verify_paths_equal_to_jax(trees):
    rows, tb, tt, jt = trees
    idx = [0, 5, 17, 31]
    paths = tb.open(tt, idx)
    assert paths.dtype == object and paths.shape == (4, 3)
    assert paths.tolist() == jhb.Bn254Backend().open(jt, idx).tolist()
    sub = torch.from_numpy(np.ascontiguousarray(rows[idx].T).view(np.int64))
    digests = tb.hash_rows(sub)
    assert tb.verify_paths(digests, idx, paths, tt.cap)
    jdig = jhb.Bn254Backend().hash_rows(rows[idx].astype(object))
    assert jhb.Bn254Backend().verify_paths(jdig, idx, paths, jt.cap)
    bad = paths.copy()
    bad[2, 1] = int(bad[2, 1]) + 1
    assert not tb.verify_paths(digests, idx, bad, tt.cap)
    assert not tb.verify_paths(digests, [1, 5, 17, 31], paths, tt.cap)
    assert not tb.verify_paths(digests, idx, paths,
                               [v + 1 for v in tt.cap])


def test_transcript_equal_to_jax():
    """Absorbs of Goldilocks ints, of a field tensor and of Fr values; base
    and extension challenges and query indices from the Fr squeezes."""
    rng = np.random.default_rng(12)
    t = thb.Bn254Backend("cpu").transcript()
    j = jhb.Bn254Backend().transcript()
    gl_vals = _gl(rng, (5,)).tolist()
    fr_vals = _fr(rng, 3)
    t.absorb_ints(gl_vals)
    j.absorb_ints(gl_vals)
    t.absorb_fr(fr_vals)
    j.absorb_fr(fr_vals)
    assert t.challenge_ext_ints() == j.challenge_ext_ints()
    assert t.challenge_base() == j.challenge_base()
    t.absorb_gf(tgl.from_int(np.array(gl_vals[:3], dtype=object), "cpu"))
    j.absorb_ints(gl_vals[:3])
    assert t.query_indices(5, 64) == j.query_indices(5, 64)
    ext = t.challenge_ext()
    c0, c1 = j.challenge_ext_ints()
    assert (int(tgl.to_u64(ext.c0)), int(tgl.to_u64(ext.c1))) == (c0, c1)
