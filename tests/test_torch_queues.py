"""Port vs JAX package: the queue simulators and permutation-argument
functions of `witness/queues.py`, bit for bit (tolerance 0).

Seeded numpy inputs go through the JAX function and its counterpart in the
port on the CPU; the port's chains run one Poseidon2 permutation per
absorbed chunk (the plain version of its kernel), the JAX package's are a
`lax.scan`. XLA takes 5-25 s on the CPU to compile each shape of the JAX
chains, so tier-1 runs them at one small shape each and the larger shapes
and the simulators are `slow`; tier-1 also holds the chains against the JAX
package's queue tails in the golden proofs' public inputs
(tests/test_torch_sorters.py).
"""

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.witness import queues as jq
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.witness import queues as tq

P = jgl.P


def _field(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


# the smallest shapes the JAX package accepts (a scan of two steps) run in
# tier-1; the larger ones are `slow`
@pytest.mark.parametrize("batch,items,width", [
    pytest.param((), 2, 4, id="small"),
    pytest.param((), 5, 20, id="one", marks=pytest.mark.slow),
    pytest.param((3,), 5, 20, id="batched", marks=pytest.mark.slow)])
def test_simulate_tails_equal(batch, items, width):
    rng = np.random.default_rng(11)
    enc = _field(rng, batch + (items, width))
    head = _field(rng, batch + (4,))
    want = jgl.to_u64(jq.simulate_tails(jgl.from_u64(enc),
                                        jgl.from_u64(head)))
    got = tgl.to_u64(tq.simulate_tails(tgl.from_u64(enc, "cpu"),
                                       tgl.from_u64(head, "cpu")))
    assert got.shape == batch + (items + 1, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("items", [
    pytest.param(2, id="small"),
    pytest.param(7, id="seven", marks=pytest.mark.slow)])
def test_simulate_states_full_equal(items):
    rng = np.random.default_rng(12)
    enc = _field(rng, (items, 8))
    head = _field(rng, (12,))
    want = jgl.to_u64(jq.simulate_states_full(jgl.from_u64(enc),
                                              jgl.from_u64(head)))
    got = tgl.to_u64(tq.simulate_states_full(tgl.from_u64(enc, "cpu"),
                                             tgl.from_u64(head, "cpu")))
    assert got.shape == (items + 1, 12)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_grand_product_chain_equal(n):
    rng = np.random.default_rng(n)
    terms = _field(rng, (2, n))
    terms[0, 0] = P - 1
    want = jgl.to_u64(jq.grand_product_chain(jgl.from_u64(terms)))
    got = tgl.to_u64(tq.grand_product_chain(tgl.from_u64(terms, "cpu")))
    assert np.array_equal(got, want)


def test_sort_by_u64_keys_equal_with_top_bit_keys_and_ties():
    """Keys whose top bit is set sort above all others (unsigned order of
    the u64 pattern), and equal keys keep their input order."""
    rng = np.random.default_rng(13)
    n = 200
    hi = rng.integers(0, 1 << 31, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    hi[:20] |= np.uint64(1 << 31)       # top bit of the u64 set
    hi[20:60] = hi[60:100]              # ties on hi ...
    lo[20:40] = lo[60:80]               # ... and on the whole key
    hi[100] = (1 << 32) - 1
    lo[100] = (1 << 32) - 1             # the largest key
    hi[101] = lo[101] = 0               # the smallest
    vals = _field(rng, (n,))
    jh, jl, jv, jidx = jq.sort_by_u64_keys(
        hi.astype(np.uint32), lo.astype(np.uint32), jgl.from_u64(vals))
    th, tl, tv, tidx = tq.sort_by_u64_keys(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), tgl.from_u64(vals, "cpu"))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx).astype(np.int64))
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))
    assert np.array_equal(tgl.to_u64(tv), jgl.to_u64(jv))
    assert int(tidx[0]) == 101 and int(tidx[-1]) == 100
    assert set(tidx[-21:-1].tolist()) == set(range(20))


def test_fs_challenge_terms_equal():
    rng = np.random.default_rng(14)
    tuples = _field(rng, (9, 20))
    ch = _field(rng, (20,))
    gamma = _field(rng, ())
    want = jgl.to_u64(jq.fs_challenge_terms(
        jgl.from_u64(tuples), jgl.from_u64(ch), jgl.from_u64(gamma)))
    got = tgl.to_u64(tq.fs_challenge_terms(
        tgl.from_u64(tuples, "cpu"), tgl.from_u64(ch, "cpu"),
        tgl.from_u64(gamma, "cpu")))
    assert np.array_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("flavor,width", [("narrow", 20), ("narrow", 5),
                                          ("full", 8)])
def test_queue_simulators_equal(flavor, width):
    """push / push_many, tails, state, split_by and merge of both
    simulators (a narrow width that is padded up to whole rate chunks
    included)."""
    rng = np.random.default_rng(width)
    rows = [[int(v) for v in r] for r in _field(rng, (6, width))]
    jcls, tcls = ((jq.QueueSimulator, tq.QueueSimulator) if flavor ==
                  "narrow" else (jq.FullWidthQueueSimulator,
                                 tq.FullWidthQueueSimulator))
    jsim, tsim = jcls(width=width), tcls(width=width, device="cpu")
    jsim.push(rows[0])
    tsim.push(rows[0])
    jsim.push_many(rows[1:])
    tsim.push_many(rows[1:])
    want = [[int(v) for v in r] for r in jsim.tails()]
    assert [[int(v) for v in r] for r in tsim.tails()] == want
    assert tsim.state() == tq.QueueState(**vars(jsim.state()))
    jparts, tparts = jsim.split_by(4), tsim.split_by(4)
    assert len(tparts) == len(jparts) == 2
    for jp, tp in zip(jparts, tparts):
        assert tp.head == jp.head and tp.tail == jp.tail
        assert len(tp) == len(jp)
    merged = tcls.merge(tparts[0], tparts[1])
    assert merged.tail == jsim.tail and merged.head == jsim.head
    # the merged queue recomputes its chain from the head
    assert [[int(v) for v in r] for r in merged.tails()] == want
