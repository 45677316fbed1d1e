"""Port vs JAX package: Fiat-Shamir transcript and FRI, bit for bit."""

import numpy as np

from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.prover import fri as jfri
from zkevm_harness_tpu.prover.transcript import Transcript as JTranscript
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu_torch import convert
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.ops import ntt as tnt
from zkevm_harness_tpu_torch.prover import fri as tfri
from zkevm_harness_tpu_torch.prover.transcript import Transcript as TTranscript
from zkevm_harness_tpu_torch.utils import serde as tserde

P = jgl.P


def _script(tr, to_field):
    """One scripted sequence of absorbs and draws; returns everything drawn."""
    rng = np.random.default_rng(5)
    ints = [int(v) for v in rng.integers(0, P, size=40, dtype=np.uint64)]
    out = []
    tr.absorb_ints(ints[:3])            # stays buffered
    tr.absorb_ints(ints[3:16])          # 16 in all: two full chunks
    out.append(tr.challenge_ext_ints())
    out.append([tr.challenge_base() for _ in range(9)])  # > RATE: lazy permute
    dev_vals = np.array(ints[16:26], dtype=np.uint64)
    tr.absorb_gf_device(to_field(dev_vals))  # one chunk, remainder of 2 buffered
    tr.absorb_ints(ints[26:27])              # remainder grows to 3
    c = tr.challenge_ext()                   # flushes the padded remainder
    out.append(c)
    out.append(tr.challenge_base())
    tr.absorb_ints(ints[27:32])              # 5 buffered
    tr.absorb_gf_device(to_field(np.array(ints[32:40], dtype=np.uint64)))
    out.append([int(v) for v in tr.query_indices(20, 1 << 10)])
    out.append(tr.challenge_ext_ints())
    return out


def test_transcript_script_matches_jax():
    jt = JTranscript(domain_tag=5)
    tt = TTranscript(domain_tag=5, device="cpu")
    jout = _script(jt, jgl.from_u64)
    tout = _script(tt, lambda u: tgl.from_u64(u, "cpu"))
    jc, tc = jout.pop(2), tout.pop(2)  # the ext challenge drawn as field scalars
    assert (int(jgl.to_ints(jc.c0)), int(jgl.to_ints(jc.c1))) == \
        (int(tgl.to_ints(tc.c0)), int(tgl.to_ints(tc.c1)))
    assert jout == tout
    assert np.array_equal(jgl.to_u64(jt._state), tgl.to_u64(tt._state))
    assert jt._buffer == tt._buffer


def test_absorb_gf_device_leaves_the_state_of_absorb_ints():
    vals = [int(v) for v in np.random.default_rng(6).integers(
        0, P, size=21, dtype=np.uint64)]
    a = TTranscript(device="cpu")
    a.absorb_ints(vals[:2])
    a.absorb_gf_device(tgl.from_int(vals[2:], "cpu"))
    b = TTranscript(device="cpu")
    b.absorb_ints(vals)
    assert a._buffer == b._buffer and len(a._buffer) == 5
    assert np.array_equal(tgl.to_u64(a._state), tgl.to_u64(b._state))
    assert a.challenge_ext_ints() == b.challenge_ext_ints()


def _ext_np(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, P, size=n, dtype=np.uint64),
            rng.integers(0, P, size=n, dtype=np.uint64))


def test_fold_matches_jax():
    c0, c1 = _ext_np(7, 32)
    alpha = (0x1234567 % P, P - 9)
    jcw = jgl.GF2(jgl.from_u64(c0), jgl.from_u64(c1))
    tcw = tgl.GF2(tgl.from_u64(c0, "cpu"), tgl.from_u64(c1, "cpu"))
    want = jfri._fold_eager(jcw, jgl.ext_from_ints(*alpha),
                            jfri._inv_domain_half(32, 7))
    got = tfri._fold_eager(tcw, tgl.ext_from_ints(alpha[0], alpha[1], "cpu"),
                           tfri._inv_domain_half(32, 7, "cpu"))
    assert np.array_equal(jgl.to_u64(want.c0), tgl.to_u64(got.c0))
    assert np.array_equal(jgl.to_u64(want.c1), tgl.to_u64(got.c1))
    jr = jfri._pair_leaf_rows(jcw)
    tr_ = tfri._pair_leaf_rows(tcw)
    assert np.array_equal(jgl.to_u64(jr), tgl.to_u64(tr_))


def test_fri_prove_and_verify_match_jax():
    """A whole FRI over 64 points (degree < 32, rate 2): both packages give
    the same proof, and each verifier accepts it."""
    n0, shift = 64, 7
    k0, k1 = _ext_np(8, 32)
    pad = np.zeros(32, dtype=np.uint64)
    coeffs = tgl.from_u64(np.stack([np.concatenate([k0, pad]),
                                    np.concatenate([k1, pad])]), "cpu")
    cw = tnt.ntt(tnt.scale_by_powers(coeffs, shift))
    cw_np = tgl.to_u64(cw)
    tcw = tgl.GF2(cw[0], cw[1])
    jcw = jgl.GF2(jgl.from_u64(cw_np[0]), jgl.from_u64(cw_np[1]))

    seedvals = [3, 1, 4, 1, 5, 9, 2, 6]
    ttr = TTranscript(device="cpu")
    ttr.absorb_ints(seedvals)
    jtr = JTranscript()
    jtr.absorb_ints(seedvals)
    tcfg = tfri.FriConfig(folding_rounds=3, cap_size=4, num_queries=4,
                          lde_factor=2)
    jcfg = jfri.FriConfig(folding_rounds=3, cap_size=4, num_queries=4,
                          lde_factor=2)
    tproof = tfri.fri_prove(tcw, shift, ttr, tcfg)
    jproof = jfri.fri_prove(jcw, shift, jtr, jcfg)
    assert tserde.proof_to_json(tproof) == jserde.proof_to_json(jproof)
    assert len(tproof.caps) == 2 and len(tproof.final_poly) == 8
    assert all(c == (0, 0) for c in tproof.final_poly[4:])

    def codeword0_at(i):
        return (int(cw_np[0][i]), int(cw_np[1][i]))

    tv = TTranscript(device="cpu")
    tv.absorb_ints(seedvals)
    as_port = convert.proof_to_package(jproof)
    assert isinstance(as_port, tfri.FriProof)
    assert tfri.fri_verify(as_port, n0, shift, tv, tcfg, codeword0_at)
    jv = JTranscript()
    jv.absorb_ints(seedvals)
    as_jax = convert.proof_to_package(tproof, jserde.default_registry())
    assert isinstance(as_jax, jfri.FriProof)
    assert jfri.fri_verify(as_jax, n0, shift, jv, jcfg, codeword0_at)

    # a changed layer-0 value is caught
    tv2 = TTranscript(device="cpu")
    tv2.absorb_ints(seedvals)
    pos = int(tproof.query_positions[0]) % (n0 // 2)
    assert not tfri.fri_verify(
        tproof, n0, shift, tv2, tcfg,
        lambda i: (codeword0_at(i)[0] ^ (i == pos), codeword0_at(i)[1]))
