"""Sha256 round-function circuit: the type-6 compute core.

The reference sha256 circuit
(circuit_definitions base_layer sha256_round_function + the decomposer
src/witness/individual_circuits/sha256_round_function.rs:23) proves batches
of sha256 compressions driven by the demuxed precompile queue. This module
proves the COMPRESSIONS — the hot compute — with per-invocation
(state_in, block, state_out) triples bound to the witness decomposer's
replay (witness/precompile_rounds.py sha256_decompose) through the same
two-rep Reed-Solomon-fingerprint accumulator as the keccak circuit.

Word+bit hybrid layout (no lookup tables):

  - one row per compression round; ROWS_PER_INVOCATION = 66 rows per
    invocation: rows 0..63 hold the working state (a..h) ENTERING round r,
    row 64 is the output row (state after round 63 + digest feed-forward),
    row 65 is an idle carry row (validity may drop at its end);
  - working state a..h as 8 x 32 bit columns; sigma/ch/maj are closed-form
    degree-<=3 boolean polynomials (xor3(a,b,c) = a+b+c-2(ab+bc+ca)+4abc,
    ch = ef + g - eg, maj = ab+bc+ca-2abc);
  - message schedule as a 16-word x 32-bit shift register W[0..15]: row r
    holds w[r..r+15]; W_next[k] = W[k+1] (480 degree-1 copies) and
    W_next[15] is the scheduled word, an exact u34 sum split by 2 carry
    bits;
  - round additions are exact word equations with boolean carry columns
    (e_new: u35 -> 3 carry bits, a_new: u35 -> 3 carry bits);
  - digest feed-forward: h_in carried as 8 word columns from the absorb row
    to the output row, D[j] = HIN[j] + word_j(state@64) - 2^32*cd_j;
  - binding: 2 independent fingerprints acc *= gamma + sum_j limb_j ch^j
    over the 32 u32 limbs (h_in 8, block 16, digest 8) per invocation —
    challenges drawn AFTER committing the invocation data;
  - FSM: validity flags + invocation count chain across instances
    (acc_in/out, cnt_in/out public inputs).

Counterpart of the JAX package's `circuits/sha256_circuit.py`. The port's
differences, none in what is computed: the round core (booleanity, message
schedule, round function, h_in carry) is one function, `sha256_core_gates`,
that the code decommitter shares; on the device algebra it evaluates every
bit of a word (and every word of a row) stacked, one launch per operation,
with the constraint values in the JAX package's order (the host algebras run
the JAX package's loops); the constant rows are uint64 numpy; the witness is
built as bit planes vectorised over invocations (a compression traced in
Python only per valid invocation, every unused slot the one dummy
compression of the zero state and block, whose planes cross to the device
once and are gathered into the slots there) and handed over as int64.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from ..witness.precompile_rounds import _SHA_K
from .keccak_circuit import (LazyWords, challenge_power_gates, col_stack,
                             dot_powers, place_rows, rows_of, slot_sources,
                             stacks, validity_count_gates, words_of_bits)

P = gl.P
M32 = 0xFFFFFFFF
ROWS_PER_INVOCATION = 66
NUM_ROUNDS = 64
NUM_REPS = 2
LIMBS_IN = 24                      # h_in (8) + block words (16)
LIMBS_OUT = 8                      # digest words
POWS_PER_REP = LIMBS_IN + LIMBS_OUT


class _C:
    """Column offsets."""
    S = 0                               # 8 x 32 state bits (a..h)
    W = 256                             # 16 x 32 schedule shift register
    HIN = W + 512                       # 8 carried input words
    D = HIN + 8                         # 8 digest words
    CE = D + 8                          # 3 e_new carry bits
    CA = CE + 3                         # 3 a_new carry bits
    CW = CA + 3                         # 2 schedule carry bits
    CD = CW + 2                         # 8 digest carry bits
    PCH = CD + 8                        # 2 reps x 32 challenge powers
    GAMMA = PCH + NUM_REPS * POWS_PER_REP
    SIN = GAMMA + NUM_REPS              # carried input-half sums
    ACC = SIN + NUM_REPS                # accumulators
    V = ACC + NUM_REPS                  # block validity
    CNT = V + 1


NUM_WITNESS = _C.CNT + 1

# const columns: s_round (rows 0..63), s_sched (rows 0..62), s_absorb (row
# 0), s_out (row 64), s_carry (acc/cnt carried), s_bend (invocation end, no
# wrap), s_sin (sin carried), s_wrap (row n-1), K round-constant word
K_SR, K_SS2, K_SA, K_SO, K_SC, K_SB, K_SI, K_SW, K_K = range(9)
NUM_CONST = 9


def _one_minus(alg, v):
    return alg.add_int(alg.mul_int(v, P - 1), 1)


def _xor2(alg, a, b):
    return alg.sub(alg.add(a, b), alg.mul_int(alg.mul(a, b), 2))


def _xor3(alg, a, b, c):
    # a+b+c - 2(ab+bc+ca) + 4abc for boolean inputs (degree 3)
    s = alg.add(alg.add(a, b), c)
    p = alg.add(alg.add(alg.mul(a, b), alg.mul(b, c)), alg.mul(c, a))
    t = alg.mul(alg.mul(a, b), c)
    return alg.add(alg.sub(s, alg.mul_int(p, 2)), alg.mul_int(t, 4))


@dataclasses.dataclass(frozen=True)
class Sha256Geometry:
    log_n: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def capacity(self) -> int:
        """sha256 compressions per instance
        (cycles_per_sha256_circuit analogue)."""
        return self.n // ROWS_PER_INVOCATION


# ---------------------------------------------------------------------------
# The round core (shared with the code decommitter)
# ---------------------------------------------------------------------------

def _rot(t: torch.Tensor, r: int) -> torch.Tensor:
    """Bit rows (32, n) -> rows[(z + r) % 32]."""
    return torch.roll(t, -r, 0)


def _core_stacked(alg, w, w_next, s_r, s_s2, s_a, k_rc):
    S = col_stack(w, _C.S, 256).reshape(8, 32, -1)
    S_n = col_stack(w_next, _C.S, 256).reshape(8, 32, -1)
    Wb = col_stack(w, _C.W, 512).reshape(16, 32, -1)
    W_n = col_stack(w_next, _C.W, 512).reshape(16, 32, -1)
    out = []
    # booleanity: every bit column (state, schedule, carries), all rows
    b = torch.cat([S.reshape(256, -1), Wb.reshape(512, -1),
                   col_stack(w, _C.CE, 16)])
    out += rows_of(alg.sub(alg.mul(b, b), b))
    del b
    # schedule shift register (rows 0..62): W_next[k] = W[k+1]
    out += rows_of(alg.mul(s_s2, alg.sub(W_n[:15], Wb[1:])))

    def sigma_word(k, r1, r2, sh):
        t1, t2 = _rot(Wb[k], r1), _rot(Wb[k], r2)
        bits = torch.cat([_xor3(alg, t1[:32 - sh], t2[:32 - sh], Wb[k][sh:]),
                          _xor2(alg, t1[32 - sh:], t2[32 - sh:])])
        return words_of_bits(alg, bits)

    Sw = words_of_bits(alg, S)          # (8, n)
    Sw_n = words_of_bits(alg, S_n)
    Ww = words_of_bits(alg, Wb)         # (16, n)
    w16 = words_of_bits(alg, W_n[15])
    carry_w = alg.add(w[_C.CW], alg.mul_int(w[_C.CW + 1], 2))
    sched_sum = alg.add(alg.add(Ww[0], sigma_word(1, 7, 18, 3)),
                        alg.add(Ww[9], sigma_word(14, 17, 19, 10)))
    out.append(alg.mul(s_s2, alg.sub(
        alg.add(w16, alg.mul_int(carry_w, 1 << 32)), sched_sum)))

    def cap_sigma(i, r1, r2, r3):
        return words_of_bits(alg, _xor3(alg, _rot(S[i], r1), _rot(S[i], r2),
                                        _rot(S[i], r3)))

    e, f, g = S[4], S[5], S[6]
    ch = words_of_bits(alg, alg.add(alg.mul(e, f), alg.sub(g, alg.mul(e, g))))
    a, b2, c2 = S[0], S[1], S[2]
    p = alg.add(alg.add(alg.mul(a, b2), alg.mul(b2, c2)), alg.mul(c2, a))
    maj = words_of_bits(alg, alg.sub(
        p, alg.mul_int(alg.mul(alg.mul(a, b2), c2), 2)))
    t1 = alg.add(alg.add(Sw[7], cap_sigma(4, 6, 11, 25)),
                 alg.add(ch, alg.add(k_rc, Ww[0])))
    t2 = alg.add(cap_sigma(0, 2, 13, 22), maj)
    carry_e = alg.add(alg.add(w[_C.CE], alg.mul_int(w[_C.CE + 1], 2)),
                      alg.mul_int(w[_C.CE + 2], 4))
    carry_a = alg.add(alg.add(w[_C.CA], alg.mul_int(w[_C.CA + 1], 2)),
                      alg.mul_int(w[_C.CA + 2], 4))
    out.append(alg.mul(s_r, alg.sub(
        alg.add(Sw_n[4], alg.mul_int(carry_e, 1 << 32)),
        alg.add(Sw[3], t1))))
    out.append(alg.mul(s_r, alg.sub(
        alg.add(Sw_n[0], alg.mul_int(carry_a, 1 << 32)), alg.add(t1, t2))))
    dst, src = [1, 2, 3, 5, 6, 7], [0, 1, 2, 4, 5, 6]
    out += rows_of(alg.mul(s_r, alg.sub(Sw_n[dst], Sw[src])))
    # h_in carried from absorb row to output row; defined at s_a
    hin = col_stack(w, _C.HIN, 8)
    pair = torch.stack([alg.mul(s_a, alg.sub(hin, Sw)),
                        alg.mul(s_r, alg.sub(col_stack(w_next, _C.HIN, 8),
                                             hin))], dim=1)
    out += rows_of(pair)
    return out, Sw, Ww, Sw_n


def sha256_core_gates(alg, w, w_next, s_r, s_s2, s_a, k_rc):
    """The sha256 round core over the S / W / HIN / carry columns:
    booleanity (784), schedule shift (480) and scheduled word (1), round
    additions and copies (8), h_in definition and carry (16, interleaved).
    Returns (constraint values, the 8 state words and the 16 schedule words
    of the row, the 8 state words of the next row), the words as a stacked
    tensor on the device algebra and as a list on the host algebras."""
    if stacks(alg):
        return _core_stacked(alg, w, w_next, s_r, s_s2, s_a, k_rc)
    out = []

    def sbit(i, z):
        return w[_C.S + 32 * i + z]

    def sbit_n(i, z):
        return w_next[_C.S + 32 * i + z]

    def wbit(k, z):
        return w[_C.W + 32 * k + z]

    def wbit_n(k, z):
        return w_next[_C.W + 32 * k + z]

    def word(bit_fn, *idx):
        acc = None
        for z in range(32):
            t = alg.mul_int(bit_fn(*idx, z), 1 << z)
            acc = t if acc is None else alg.add(acc, t)
        return acc

    # booleanity: every bit column (state, schedule, carries), all rows
    for col in (list(range(_C.S, _C.S + 256))
                + list(range(_C.W, _C.W + 512))
                + list(range(_C.CE, _C.CD + 8))):
        b = w[col]
        out.append(alg.sub(alg.mul(b, b), b))

    # schedule shift register (rows 0..62): W_next[k] = W[k+1]
    for k in range(15):
        for z in range(32):
            out.append(alg.mul(s_s2, alg.sub(wbit_n(k, z), wbit(k + 1, z))))

    # scheduled word: w16 = w0 + sg0(w1) + w9 + sg1(w14) - 2^32*cw
    # sg0(x) = rotr7 ^ rotr18 ^ shr3 ; sg1(x) = rotr17 ^ rotr19 ^ shr10
    def sigma_word(k, r1, r2, sh):
        acc = None
        for z in range(32):
            t1 = wbit(k, (z + r1) % 32)
            t2 = wbit(k, (z + r2) % 32)
            if z + sh < 32:
                bit = _xor3(alg, t1, t2, wbit(k, z + sh))
            else:
                bit = _xor2(alg, t1, t2)
            t = alg.mul_int(bit, 1 << z)
            acc = t if acc is None else alg.add(acc, t)
        return acc

    w16 = word(wbit_n, 15)
    carry_w = alg.add(w[_C.CW], alg.mul_int(w[_C.CW + 1], 2))
    sched_sum = alg.add(alg.add(word(wbit, 0), sigma_word(1, 7, 18, 3)),
                        alg.add(word(wbit, 9), sigma_word(14, 17, 19, 10)))
    out.append(alg.mul(s_s2, alg.sub(
        alg.add(w16, alg.mul_int(carry_w, 1 << 32)), sched_sum)))

    # round function (rows 0..63): state words a..h = indices 0..7
    def cap_sigma(i, r1, r2, r3):
        acc = None
        for z in range(32):
            bit = _xor3(alg, sbit(i, (z + r1) % 32),
                        sbit(i, (z + r2) % 32), sbit(i, (z + r3) % 32))
            t = alg.mul_int(bit, 1 << z)
            acc = t if acc is None else alg.add(acc, t)
        return acc

    def ch_word():
        acc = None
        for z in range(32):
            e, f, g = sbit(4, z), sbit(5, z), sbit(6, z)
            bit = alg.add(alg.mul(e, f), alg.sub(g, alg.mul(e, g)))
            t = alg.mul_int(bit, 1 << z)
            acc = t if acc is None else alg.add(acc, t)
        return acc

    def maj_word():
        acc = None
        for z in range(32):
            a, b2, c2 = sbit(0, z), sbit(1, z), sbit(2, z)
            p = alg.add(alg.add(alg.mul(a, b2), alg.mul(b2, c2)),
                        alg.mul(c2, a))
            bit = alg.sub(p, alg.mul_int(alg.mul(alg.mul(a, b2), c2), 2))
            t = alg.mul_int(bit, 1 << z)
            acc = t if acc is None else alg.add(acc, t)
        return acc

    Sw = LazyWords(lambda j: word(sbit, j), 8)
    Sw_n = LazyWords(lambda j: word(sbit_n, j), 8)
    Ww = LazyWords(lambda k: word(wbit, k), 16)
    t1 = alg.add(alg.add(Sw[7], cap_sigma(4, 6, 11, 25)),
                 alg.add(ch_word(), alg.add(k_rc, Ww[0])))
    t2 = alg.add(cap_sigma(0, 2, 13, 22), maj_word())
    carry_e = alg.add(alg.add(w[_C.CE], alg.mul_int(w[_C.CE + 1], 2)),
                      alg.mul_int(w[_C.CE + 2], 4))
    carry_a = alg.add(alg.add(w[_C.CA], alg.mul_int(w[_C.CA + 1], 2)),
                      alg.mul_int(w[_C.CA + 2], 4))
    # e_new = d + t1 mod 2^32 ; a_new = t1 + t2 mod 2^32
    out.append(alg.mul(s_r, alg.sub(
        alg.add(Sw_n[4], alg.mul_int(carry_e, 1 << 32)),
        alg.add(Sw[3], t1))))
    out.append(alg.mul(s_r, alg.sub(
        alg.add(Sw_n[0], alg.mul_int(carry_a, 1 << 32)),
        alg.add(t1, t2))))
    # b,c,d = a,b,c and f,g,h = e,f,g (word equations; booleanity pins
    # the bits)
    for (dst, src) in ((1, 0), (2, 1), (3, 2), (5, 4), (6, 5), (7, 6)):
        out.append(alg.mul(s_r, alg.sub(Sw_n[dst], Sw[src])))

    # h_in carried from absorb row to output row; defined at s_a
    for j in range(8):
        hin = w[_C.HIN + j]
        out.append(alg.mul(s_a, alg.sub(hin, Sw[j])))
        out.append(alg.mul(s_r, alg.sub(w_next[_C.HIN + j], hin)))
    return out, Sw, Ww, Sw_n


def concat_words(alg, *groups):
    """Word values of several groups as one sequence (stacked tensors on
    the device algebra, lists on the host)."""
    if stacks(alg):
        return torch.cat(list(groups))
    return LazyWords.concat(*groups)


def sha256_ir(log_n: int) -> pk.PlonkishIR:
    geo = Sha256Geometry(log_n)
    n = geo.n
    assert geo.capacity >= 1

    def eval_gates(alg, w, w_next, c):
        s_r, s_s2, s_a = c[K_SR], c[K_SS2], c[K_SA]
        s_o, s_c, s_b = c[K_SO], c[K_SC], c[K_SB]
        s_i, s_w, k_rc = c[K_SI], c[K_SW], c[K_K]
        out, Sw, Ww, _ = sha256_core_gates(alg, w, w_next, s_r, s_s2, s_a,
                                           k_rc)

        # digest at the output row: D = HIN + state@64 - 2^32*cd
        for j in range(8):
            out.append(alg.mul(s_o, alg.sub(
                alg.add(w[_C.D + j], alg.mul_int(w[_C.CD + j], 1 << 32)),
                alg.add(w[_C.HIN + j], Sw[j]))))

        # validity / count chains (identical shape to the keccak circuit)
        v = w[_C.V]
        out += validity_count_gates(alg, v, w_next[_C.V], w[_C.CNT],
                                    w_next[_C.CNT], s_b, s_w, s_o, s_c)

        # fingerprint machinery (challenge-after-commit binding)
        limbs_in = concat_words(alg, Sw, Ww)
        digest = (col_stack(w, _C.D, LIMBS_OUT) if stacks(alg)
                  else [w[_C.D + j] for j in range(LIMBS_OUT)])
        for rep in range(NUM_REPS):
            pbase = _C.PCH + rep * POWS_PER_REP
            gamma = w[_C.GAMMA + rep]
            sin, sin_n = w[_C.SIN + rep], w_next[_C.SIN + rep]
            acc, acc_n = w[_C.ACC + rep], w_next[_C.ACC + rep]
            out += challenge_power_gates(alg, w, w_next, pbase, POWS_PER_REP,
                                         _C.GAMMA + rep, s_a)
            # input-half sum staged at the absorb row: h_in words then block
            s_in = dot_powers(alg, w, pbase, limbs_in)
            out.append(alg.mul(s_a, alg.sub(sin, s_in)))
            out.append(alg.mul(s_i, alg.sub(sin_n, sin)))
            # accumulator step at the output row over the digest words
            s_out = dot_powers(alg, w, pbase + LIMBS_IN, digest)
            t = alg.add(gamma, alg.add(sin, s_out))
            gated = alg.add(alg.mul(v, t), _one_minus(alg, v))
            out.append(alg.mul(s_o, alg.sub(acc_n, alg.mul(acc, gated))))
            out.append(alg.mul(s_c, alg.sub(acc_n, acc)))
        return out

    n_constraints = (256 + 512 + 16                  # booleanity
                     + 480 + 1                       # schedule
                     + 2 + 6                         # round additions+copies
                     + 16 + 8                        # h_in carry + digest
                     + 5                             # v/cnt chains
                     + NUM_REPS * (1 + POWS_PER_REP
                                   + POWS_PER_REP - 1
                                   + 2 + 2))

    pis: List[Tuple[int, int]] = []
    for rep in range(NUM_REPS):
        pis.append((_C.PCH + rep * POWS_PER_REP, 0))
        pis.append((_C.GAMMA + rep, 0))
    pis += [(_C.ACC + rep, 0) for rep in range(NUM_REPS)]
    pis += [(_C.ACC + rep, n - 1) for rep in range(NUM_REPS)]
    pis += [(_C.V, 0), (_C.CNT, 0), (_C.CNT, n - 1)]

    return pk.PlonkishIR(
        log_n=log_n, num_witness=NUM_WITNESS, num_const=NUM_CONST,
        gate_degree=5, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis))


def round_const_rows(n: int, capacity: int, num_const: int, k_sr: int,
                     k_ss2: int, k_sa: int, k_so: int, k_k: int
                     ) -> np.ndarray:
    """(n, num_const) uint64 rows with the selectors that both sha256
    circuits set alike: s_round and K (rows 0..63 of every slot), s_sched
    (rows 0..62), s_absorb (row 0), s_out (row 64); rows past the last slot
    stay zero."""
    block = np.zeros((ROWS_PER_INVOCATION, num_const), dtype=np.uint64)
    block[:NUM_ROUNDS, k_sr] = 1
    block[:NUM_ROUNDS, k_k] = np.array(_SHA_K, dtype=np.uint64)
    block[:NUM_ROUNDS - 1, k_ss2] = 1
    block[0, k_sa] = 1
    block[NUM_ROUNDS, k_so] = 1
    rows = np.zeros((n, num_const), dtype=np.uint64)
    rows[:capacity * ROWS_PER_INVOCATION] = np.tile(block, (capacity, 1))
    return rows


def _const_rows(geo: Sha256Geometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n, span = geo.n, geo.capacity * ROWS_PER_INVOCATION
    rows = round_const_rows(n, geo.capacity, NUM_CONST, K_SR, K_SS2, K_SA,
                            K_SO, K_K)
    rows[:span, K_SI] = rows[:span, K_SR]
    rows[:, K_SC] = 1
    rows[NUM_ROUNDS:span:ROWS_PER_INVOCATION, K_SC] = 0
    rows[ROWS_PER_INVOCATION - 1:span:ROWS_PER_INVOCATION, K_SB] = 1
    rows[n - 1, K_SC] = 0
    rows[n - 1, K_SB] = 0
    rows[n - 1, K_SW] = 1
    return rows


def sha256_setup(ir: pk.PlonkishIR, geo: Sha256Geometry,
                 cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    return pk.build_setup(ir, _const_rows(geo).T, pk.CopyWiring.identity(),
                          cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def sha256_round_trace(h_in: Sequence[int], block: bytes):
    """Per-round traces for one compression: returns (S_rows (65, 8 words),
    W_words (list of all scheduled words w[0..78]), digest (8 words)).
    S_rows[r] is the working state entering round r."""
    w = list(struct.unpack(">16I", block))
    # extend far enough that the shift register rows 0..64 are defined
    for i in range(16, NUM_ROUNDS + 16):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    state = [int(x) & M32 for x in h_in]
    S_rows = []
    for r in range(NUM_ROUNDS):
        S_rows.append(list(state))
        a, b, c, d, e, f, g, hh = state
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (hh + s1 + ch + _SHA_K[r] + w[r]) & ((1 << 40) - 1)
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        state = [(t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g]
    S_rows.append(list(state))
    digest = [(int(h_in[j]) + state[j]) & M32 for j in range(8)]
    return S_rows, w, digest


def _rotr(x, s):
    return ((x >> s) | (x << (32 - s))) & M32


@dataclasses.dataclass
class CompressionTrace:
    """Everything the round core's rows hold for one compression slot."""
    S: np.ndarray        # (65, 8) working state entering each round
    w: np.ndarray        # (80,) scheduled words
    digest: np.ndarray   # (8,)
    ce: np.ndarray       # (64,) e_new carries
    ca: np.ndarray       # (64,) a_new carries
    cw: np.ndarray       # (63,) schedule carries
    cd: np.ndarray       # (8,) digest carries


def compression_trace(h_in: Sequence[int], block: bytes) -> CompressionTrace:
    """The trace of one compression with the carries of its word
    equations."""
    S_rows, w, dg = sha256_round_trace(h_in, block)
    ce, ca, cw = [], [], []
    for r in range(NUM_ROUNDS):
        a, b, c2, d, e, f, g, hh = S_rows[r]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        chv = (e & f) ^ (~e & g) & M32
        t1 = hh + s1 + chv + _SHA_K[r] + w[r]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c2) ^ (b & c2)
        t2 = s0 + maj
        ce.append((d + t1 - S_rows[r + 1][4]) >> 32)
        ca.append((t1 + t2 - S_rows[r + 1][0]) >> 32)
        if r < NUM_ROUNDS - 1:
            sg0 = (_rotr(w[r + 1], 7) ^ _rotr(w[r + 1], 18) ^ (w[r + 1] >> 3))
            sg1 = (_rotr(w[r + 14], 17) ^ _rotr(w[r + 14], 19)
                   ^ (w[r + 14] >> 10))
            cw.append((w[r] + sg0 + w[r + 9] + sg1 - w[r + 16]) >> 32)
    cd = [(int(h_in[j]) + S_rows[NUM_ROUNDS][j]) >> 32 for j in range(8)]
    u = lambda v: np.array(v, dtype=np.uint64)
    return CompressionTrace(u(S_rows), u(w), u(dg), u(ce), u(ca), u(cw),
                            u(cd))


def stacked_traces(traces: Sequence[CompressionTrace]) -> CompressionTrace:
    """The traces, then the dummy compression of the zero state and block
    (the trace every unused slot holds), each field stacked along a new
    first axis."""
    traces = list(traces) + [compression_trace((0,) * 8, b"\x00" * 64)]
    return CompressionTrace(**{
        f.name: np.stack([getattr(t, f.name) for t in traces])
        for f in dataclasses.fields(CompressionTrace)})


def word_bits(words: np.ndarray) -> np.ndarray:
    """uint64 words (...,) -> uint8 bits (..., 32), least significant
    first."""
    return ((words[..., None] >> np.arange(32, dtype=np.uint64))
            & np.uint64(1)).astype(np.uint8)


def place_round_core(W: torch.Tensor, tr: CompressionTrace,
                     h_in: np.ndarray, src: np.ndarray):
    """Write the round core's columns (S, W, HIN, D, CE, CA, CW, CD) of
    every slot: rows 0..64 of the state, the schedule register and h_in,
    the carries of rows 0..63 (0..62 for the schedule), the digest and its
    carries on row 64. tr and h_in ((traces, 8) uint64) hold the distinct
    traces; src: the trace of each slot."""
    u = h_in.shape[0]
    R = ROWS_PER_INVOCATION
    rows = slice(0, NUM_ROUNDS + 1)
    place_rows(W, _C.S, word_bits(tr.S).reshape(u, NUM_ROUNDS + 1, 256),
               rows, R, src)
    reg = tr.w[:, np.arange(NUM_ROUNDS + 1)[:, None] + np.arange(16)]
    place_rows(W, _C.W, word_bits(reg).reshape(u, NUM_ROUNDS + 1, 512),
               rows, R, src)
    del reg
    place_rows(W, _C.HIN, np.repeat(h_in[:, None], NUM_ROUNDS + 1, axis=1),
               rows, R, src)
    carries = np.zeros((u, NUM_ROUNDS, 8), dtype=np.uint64)
    for i in range(3):
        carries[:, :, i] = (tr.ce >> np.uint64(i)) & np.uint64(1)
        carries[:, :, 3 + i] = (tr.ca >> np.uint64(i)) & np.uint64(1)
    for i in range(2):
        carries[:, :NUM_ROUNDS - 1, 6 + i] = \
            (tr.cw >> np.uint64(i)) & np.uint64(1)
    place_rows(W, _C.CE, carries, slice(0, NUM_ROUNDS), R, src)
    out_row = slice(NUM_ROUNDS, NUM_ROUNDS + 1)
    place_rows(W, _C.D, tr.digest[:, None], out_row, R, src)
    place_rows(W, _C.CD, tr.cd[:, None], out_row, R, src)


def fingerprint(challenges: Sequence[int], gammas: Sequence[int],
                triples, acc_in: Sequence[int] = (1, 1)) -> List[int]:
    """Host-side accumulator over (h_in, block, digest) triples — what the
    circuit's public accumulator outputs must equal."""
    accs = [int(a) % P for a in acc_in]
    for (h_in, block, digest) in triples:
        limbs = ([int(x) & M32 for x in h_in]
                 + list(struct.unpack(">16I", block))
                 + [int(x) & M32 for x in digest])
        for rep in range(NUM_REPS):
            ch, gm = int(challenges[rep]) % P, int(gammas[rep]) % P
            t = gm
            pw = ch
            for limb in limbs:
                t = (t + pw * limb) % P
                pw = pw * ch % P
            accs[rep] = accs[rep] * t % P
    return accs


@dataclasses.dataclass
class Sha256InstanceInputs:
    """One instance's payload: (h_in, block, digest) compression triples."""
    triples: List[Tuple[Tuple[int, ...], bytes, Tuple[int, ...]]]
    challenges: Tuple[int, int]
    gammas: Tuple[int, int]
    acc_in: Tuple[int, int]
    cnt_in: int


def sha256_witness(ir: pk.PlonkishIR, geo: Sha256Geometry,
                   inst: Sha256InstanceInputs, device=None) -> gl.GF:
    """The (num_witness, n) witness on `device` (`None` means the CUDA
    card)."""
    from .keccak_circuit import challenge_powers
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = len(inst.triples)
    assert count <= cap
    R = ROWS_PER_INVOCATION
    span = cap * R
    h_ins = np.zeros((count + 1, 8), dtype=np.uint64)
    traces = []
    for k, (h_in, block, digest) in enumerate(inst.triples):
        h_in = tuple(int(x) & M32 for x in h_in)
        h_ins[k] = h_in
        t = compression_trace(h_in, block)
        assert tuple(int(x) for x in t.digest) == \
            tuple(int(x) & M32 for x in digest), \
            "digest does not match sha256-compress(state_in, block)"
        traces.append(t)
    tr = stacked_traces(traces)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    place_round_core(W, tr, h_ins, slot_sources(count, cap))

    # fingerprint staging, validity and counts
    gm = [int(g) % P for g in inst.gammas]
    pows = challenge_powers(inst.challenges, POWS_PER_REP)
    small = np.zeros((NUM_WITNESS - _C.PCH, n), dtype=np.uint64)
    S = lambda col: small[col - _C.PCH]
    slot = lambda col: S(col)[:span].reshape(cap, R)
    for rep in range(NUM_REPS):
        for j in range(POWS_PER_REP):
            S(_C.PCH + rep * POWS_PER_REP + j)[:] = pows[rep][j]
        S(_C.GAMMA + rep)[:] = gm[rep]
    accs = [int(a) % P for a in inst.acc_in]
    cnt = int(inst.cnt_in)
    for k in range(cap):
        valid = k < count
        if valid:
            h_in, block, _digest = inst.triples[k]
            limbs_in = list(h_ins[k]) + list(struct.unpack(">16I", block))
        for rep in range(NUM_REPS):
            sin = (sum(pows[rep][j] * int(limbs_in[j])
                       for j in range(LIMBS_IN)) % P) if valid else 0
            slot(_C.SIN + rep)[k, :NUM_ROUNDS + 1] = sin
            slot(_C.ACC + rep)[k, :NUM_ROUNDS + 1] = accs[rep]
            if valid:
                sout = sum(pows[rep][LIMBS_IN + j] * int(tr.digest[k, j])
                           for j in range(LIMBS_OUT)) % P
                accs[rep] = accs[rep] * ((gm[rep] + sin + sout) % P) % P
            slot(_C.ACC + rep)[k, NUM_ROUNDS + 1:] = accs[rep]
        slot(_C.V)[k] = 1 if valid else 0
        slot(_C.CNT)[k, :NUM_ROUNDS + 1] = cnt
        if valid:
            cnt += 1
        slot(_C.CNT)[k, NUM_ROUNDS + 1:] = cnt
    # idle tail region (rows beyond capacity*66): accs/cnt carried
    for rep in range(NUM_REPS):
        S(_C.ACC + rep)[span:] = accs[rep]
    S(_C.CNT)[span:] = cnt
    W[_C.PCH:] = gl.from_u64(small, device)
    return W


def expected_public_inputs(geo: Sha256Geometry, inst: Sha256InstanceInputs
                           ) -> List[int]:
    acc_out = fingerprint(inst.challenges, inst.gammas, inst.triples,
                          inst.acc_in)
    out = []
    for rep in range(NUM_REPS):
        out += [int(inst.challenges[rep]) % P, int(inst.gammas[rep]) % P]
    out += [int(a) % P for a in inst.acc_in]
    out += acc_out
    out += [1 if inst.triples else 0,
            int(inst.cnt_in), int(inst.cnt_in) + len(inst.triples)]
    return out


def instance_public_inputs(geo: Sha256Geometry, inst_w, challenges_gammas
                           ) -> List[int]:
    """PIs from a decomposer-level RoundFunctionInstanceWitness
    (witness/precompile_circuits.py) — the typed-layer-surface bridge."""
    ch, gm = challenges_gammas
    inst = instance_inputs(inst_w.invocations, ch, gm, inst_w.acc_in,
                           inst_w.cnt_in)
    return expected_public_inputs(geo, inst)


def draw_sha256_challenges(invocations, device=None
                           ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Fiat-Shamir challenges bound to the invocation data (drawn AFTER
    committing it); the hash and the transcript run on `device` (`None`
    means the CUDA card)."""
    from ..ops import poseidon2 as p2
    from ..prover.transcript import Transcript
    device = gl.resolve_device(device)
    tr = Transcript(domain_tag=6, device=device)
    flat = []
    for inv in invocations:
        flat += ([int(x) & M32 for x in inv.state_in]
                 + list(struct.unpack(">16I", inv.block))
                 + [int(x) & M32 for x in inv.state_out])
    digest = gl.to_ints(p2.hash_elements(gl.from_int(
        [v % P for v in flat] or [0], device)))
    tr.absorb_ints([int(v) for v in digest] + [len(invocations)])
    ch = (tr.challenge_base(), tr.challenge_base())
    gm = (tr.challenge_base(), tr.challenge_base())
    return ch, gm


def instance_inputs(invocations, challenges, gammas, acc_in=(1, 1),
                    cnt_in: int = 0) -> Sha256InstanceInputs:
    """Bridge decomposer RoundFunctionInvocations (witness/
    precompile_rounds.py sha256_decompose) into the circuit payload. The
    decomposer's state_out is the post-feed-forward digest state, exactly
    what the circuit's digest row proves."""
    triples = []
    for inv in invocations:
        triples.append((tuple(int(x) & M32 for x in inv.state_in),
                        bytes(inv.block),
                        tuple(int(x) & M32 for x in inv.state_out)))
    return Sha256InstanceInputs(triples=triples,
                                challenges=tuple(challenges),
                                gammas=tuple(gammas),
                                acc_in=tuple(acc_in), cnt_in=cnt_in)
