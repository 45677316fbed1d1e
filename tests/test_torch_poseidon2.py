"""Port vs JAX package: Poseidon2 permutation and sponge, bit for bit.

On the CPU the port's `permute` is the plain version of its CUDA kernel
(`poseidon2_permute_plain`); the JAX side is the scanned XLA path that the
Pallas kernel body is pinned to by tests/test_pallas.py.
"""

import os

import numpy as np
import pytest
import torch

import zkevm_harness_tpu
import zkevm_harness_tpu_torch
from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.ops import poseidon2 as jp2
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.ops import poseidon2 as tp2
from zkevm_harness_tpu_torch.ops import poseidon2_params as tparams

P = jgl.P

PINNED = [
    16554216206709474952, 11165653368081738105, 15510491069834582656,
    904424896032794924, 4443680892611024698, 12657429491349814692,
    16757781937420386340, 15944128758986577910, 13120191295696364543,
    15956608950573169034, 2873883470026321187, 4028397520777608596]


def _states16():
    vals = np.random.default_rng(0).integers(0, P, size=(16, 12),
                                             dtype=np.uint64)
    vals[0] = P - 1
    vals[1, :6] = 0
    vals[1, 6:] = P - 2
    vals[2] = 0
    return vals


def test_params_json_is_a_byte_identical_copy():
    src = os.path.join(os.path.dirname(zkevm_harness_tpu.__file__), "params",
                       "poseidon2_goldilocks.json")
    dst = os.path.join(os.path.dirname(zkevm_harness_tpu_torch.__file__),
                       "params", "poseidon2_goldilocks.json")
    assert os.path.abspath(dst) == tparams.PARAMS_PATH
    with open(src, "rb") as f, open(dst, "rb") as g:
        assert f.read() == g.read()


def test_permute_plain_matches_xla_on_edge_states():
    vals = _states16()
    want = jgl.to_u64(jp2._permute_xla(jgl.from_u64(vals)))
    got = ck.poseidon2_permute_plain(tgl.from_u64(vals, "cpu"))
    assert np.array_equal(want, tgl.to_u64(got))


def test_one_state_host_permutation_equals_the_plain_version():
    """A lone state on the CPU is permuted in Python ints (the serial
    sponges); same function as the plain tensor version, edge states and
    random ones, as (12,) and as (1, 12)."""
    rng = np.random.default_rng(5)
    vals = np.concatenate([_states16(), rng.integers(
        0, P, size=(8, 12), dtype=np.uint64)])
    want = ck.poseidon2_permute_plain(tgl.from_u64(vals, "cpu"))
    for i, row in enumerate(vals):
        st = tgl.from_u64(row, "cpu")
        assert torch.equal(ck.poseidon2_permute_one_host(st), want[i])
        assert torch.equal(tp2.permute(st[None]), want[i][None])


def test_pinned_permutation_vector():
    st = tgl.from_int(list(range(12)), "cpu")
    assert [int(v) for v in tgl.to_ints(tp2.permute(st))] == PINNED
    # a single state in a batch of one, as the transcript permutes it
    assert [int(v) for v in
            tgl.to_ints(ck.poseidon2_permute_plain(st[None]))[0]] == PINNED


@pytest.mark.parametrize("n", [1, 8, 9, 130])
def test_hash_elements_matches_jax(n):
    vals = np.random.default_rng(n).integers(0, P, size=(5, n),
                                             dtype=np.uint64)
    want = jgl.to_u64(jp2.hash_elements(jgl.from_u64(vals)))
    got = tp2.hash_elements(tgl.from_u64(vals, "cpu"))
    assert got.shape == (5, 4)
    assert np.array_equal(want, tgl.to_u64(got))


@pytest.mark.parametrize("pieces", [(8, 8, 5), (16, 1), (24,)])
def test_absorb_elements_in_whole_chunks_is_the_hash_at_once(pieces):
    """The streamed commitment's sponge: elements absorbed in pieces of
    whole rate-8 chunks (the last piece any length), each into the state
    the one before left, give `hash_elements` of them all, which is the JAX
    package's."""
    n = sum(pieces)
    vals = np.random.default_rng(n).integers(0, P, size=(5, n),
                                             dtype=np.uint64)
    elems = tgl.from_u64(vals, "cpu")
    state, j = None, 0
    for k in pieces:
        state = tp2.absorb_elements(state, elems[:, j:j + k])
        j += k
    want = jgl.to_u64(jp2.hash_elements(jgl.from_u64(vals)))
    assert np.array_equal(tgl.to_u64(state[:, :4]), want)
    assert np.array_equal(tgl.to_u64(tp2.hash_elements(elems)), want)


def test_hash_elements_of_a_transposed_view():
    """Merkle commits hash the rows of a column-major LDE through a
    transposed view; the digest must not depend on the memory layout."""
    vals = np.random.default_rng(1).integers(0, P, size=(11, 6),
                                             dtype=np.uint64)
    cols = tgl.from_u64(vals, "cpu")
    assert np.array_equal(
        tgl.to_u64(tp2.hash_elements(cols.t())),
        tgl.to_u64(tp2.hash_elements(cols.t().contiguous())))


def test_hash_two_to_one_and_full_width_absorb_match_jax():
    rng = np.random.default_rng(2)
    left = rng.integers(0, P, size=(5, 4), dtype=np.uint64)
    right = rng.integers(0, P, size=(5, 4), dtype=np.uint64)
    want = jgl.to_u64(jp2.hash_two_to_one(jgl.from_u64(left),
                                          jgl.from_u64(right)))
    got = tp2.hash_two_to_one(tgl.from_u64(left, "cpu"),
                              tgl.from_u64(right, "cpu"))
    assert np.array_equal(want, tgl.to_u64(got))
    state = rng.integers(0, P, size=(5, 12), dtype=np.uint64)
    enc = rng.integers(0, P, size=(5, 8), dtype=np.uint64)
    want = jgl.to_u64(jp2.full_width_absorb(jgl.from_u64(state),
                                            jgl.from_u64(enc)))
    got = tp2.full_width_absorb(tgl.from_u64(state, "cpu"),
                                tgl.from_u64(enc, "cpu"))
    assert np.array_equal(want, tgl.to_u64(got))


def test_permute_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tp2.permute(tgl.zeros((4, 8), "cpu"))
    with pytest.raises(TypeError):
        tp2.permute(tgl.zeros((4, 12), "cpu").to(dtype=torch.int32))
