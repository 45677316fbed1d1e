"""A word-for-word model of `zkevm_harness_tpu_torch/csrc/bn254_fr.cuh` (the
BN254 Fr arithmetic of the card's Poseidon2-BN254 kernel) in Python ints.

Each function below replays one function of the header, instruction for
instruction: `Chain` is one asm block, whose carry flag starts unset, must
be written before it is read, and must be read before the block ends or a
new chain starts. Every word is checked to fit 32 bits, every add that
drops its carry (an instruction without `.cc`) is checked to carry
nothing, and every word a window move discards is checked to be zero. The
tests hold the model to the exact product mod p and to the range each
function of the header states, at the extremes and at seeded random
inputs, and run whole permutations and one row sponge of the kernel's
structure (`csrc/poseidon2_bn254.cu`) against the host Poseidon2-BN254 of
the port and of the JAX package. The card holds the kernel itself against
its plain version in chip_smoke.py's phase `kernels_fw`.
"""

import os

import numpy as np
import pytest

from zkevm_harness_tpu.prover import hash_backend as jhb
from zkevm_harness_tpu.utils import poseidon2_bn254 as jp2b
from zkevm_harness_tpu_torch.utils import poseidon2_bn254 as tp2b

FR = tp2b.FR
R = 1 << 256
M32 = (1 << 32) - 1
N = 8
M0 = (-pow(FR, -1, 1 << 32)) % (1 << 32)
GL_P = tp2b.GL_P


def limbs(v):
    assert 0 <= v < R
    return [(v >> (32 * j)) & M32 for j in range(N)]


def value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


P_L = limbs(FR)
Q_L = limbs(2 * FR)


def _word(*ws):
    for w in ws:
        assert isinstance(w, int) and 0 <= w <= M32, f"not a 32-bit word: {w}"


class Chain:
    """One asm block and its carry flag."""

    def __init__(self):
        self.cf = None

    def _start(self):
        assert self.cf is None, "a carry left unread"

    def _carry(self):
        assert self.cf is not None, "reads a carry this block did not write"
        c, self.cf = self.cf, None
        return c

    def _set(self, s):
        self.cf = s >> 32
        return s & M32

    def _last(self, s):
        assert s <= M32, "an add without .cc dropped a carry"
        return s

    def close(self):
        assert self.cf is None, "a carry left in the flag at the block's end"

    # add.cc / addc.cc / addc
    def add_cc(self, a, b):
        _word(a, b)
        self._start()
        return self._set(a + b)

    def addc_cc(self, a, b):
        _word(a, b)
        return self._set(a + b + self._carry())

    def addc(self, a, b):
        _word(a, b)
        return self._last(a + b + self._carry())

    # mad.lo.cc / madc.lo.cc / madc.hi.cc / madc.hi
    def mad_lo_cc(self, a, b, c):
        _word(a, b, c)
        self._start()
        return self._set(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        _word(a, b, c)
        return self._set(((a * b) & M32) + c + self._carry())

    def madc_hi_cc(self, a, b, c):
        _word(a, b, c)
        return self._set((a * b >> 32) + c + self._carry())

    def madc_hi(self, a, b, c):
        _word(a, b, c)
        return self._last((a * b >> 32) + c + self._carry())

    # sub.cc / subc.cc, and subc.u32 of zero: all ones after a borrow
    def sub_cc(self, a, b):
        _word(a, b)
        self._start()
        d = a - b
        self.cf = int(d < 0)
        return d & M32

    def subc_cc(self, a, b):
        _word(a, b)
        d = a - b - self._carry()
        self.cf = int(d < 0)
        return d & M32

    def borrow_mask(self, zero):
        assert zero == 0
        return (-self._carry()) & M32


# --- the header's functions, in its order ----------------------------------

def mul_row(acc, a, off, b):
    for k in range(0, N, 2):
        t = a[off + k] * b
        acc[k], acc[k + 1] = t & M32, t >> 32


def mac_shift_odd(e, o, a, b):
    assert o[0] == 0, "the window move drops a word that is not zero"
    c = Chain()
    e[0] = c.add_cc(e[0], o[1])
    o[0] = c.madc_lo_cc(a[1], b, o[2])
    o[1] = c.madc_hi_cc(a[1], b, o[3])
    o[2] = c.madc_lo_cc(a[3], b, o[4])
    o[3] = c.madc_hi_cc(a[3], b, o[5])
    o[4] = c.madc_lo_cc(a[5], b, o[6])
    o[5] = c.madc_hi_cc(a[5], b, o[7])
    o[6] = c.madc_lo_cc(a[7], b, 0)
    o[7] = c.madc_hi(a[7], b, 0)
    c.close()


def mac_even(e, o, a, b):
    c = Chain()
    e[0] = c.mad_lo_cc(a[0], b, e[0])
    e[1] = c.madc_hi_cc(a[0], b, e[1])
    e[2] = c.madc_lo_cc(a[2], b, e[2])
    e[3] = c.madc_hi_cc(a[2], b, e[3])
    e[4] = c.madc_lo_cc(a[4], b, e[4])
    e[5] = c.madc_hi_cc(a[4], b, e[5])
    e[6] = c.madc_lo_cc(a[6], b, e[6])
    e[7] = c.madc_hi_cc(a[6], b, e[7])
    o[7] = c.addc(o[7], 0)
    c.close()


def redc_odd(o, m):
    c = Chain()
    o[0] = c.mad_lo_cc(m, P_L[1], o[0])
    o[1] = c.madc_hi_cc(m, P_L[1], o[1])
    o[2] = c.madc_lo_cc(m, P_L[3], o[2])
    o[3] = c.madc_hi_cc(m, P_L[3], o[3])
    o[4] = c.madc_lo_cc(m, P_L[5], o[4])
    o[5] = c.madc_hi_cc(m, P_L[5], o[5])
    o[6] = c.madc_lo_cc(m, P_L[7], o[6])
    o[7] = c.madc_hi(m, P_L[7], o[7])
    c.close()


def redc_even(e, o, m):
    c = Chain()
    e[0] = c.mad_lo_cc(m, P_L[0], e[0])
    e[1] = c.madc_hi_cc(m, P_L[0], e[1])
    e[2] = c.madc_lo_cc(m, P_L[2], e[2])
    e[3] = c.madc_hi_cc(m, P_L[2], e[3])
    e[4] = c.madc_lo_cc(m, P_L[4], e[4])
    e[5] = c.madc_hi_cc(m, P_L[4], e[5])
    e[6] = c.madc_lo_cc(m, P_L[6], e[6])
    e[7] = c.madc_hi_cc(m, P_L[6], e[7])
    o[7] = c.addc(o[7], 0)
    c.close()


def redc_step(e, o):
    m = (e[0] * M0) & M32
    redc_odd(o, m)
    redc_even(e, o, m)
    assert e[0] == 0


def mul_step(e, o, a, b):
    mac_shift_odd(e, o, a, b)
    mac_even(e, o, a, b)
    redc_step(e, o)


def merge(o, e):
    assert e[0] == 0, "the window move drops a word that is not zero"
    c = Chain()
    o[0] = c.add_cc(o[0], e[1])
    for j in range(1, N - 1):
        o[j] = c.addc_cc(o[j], e[j + 1])
    o[7] = c.addc(o[7], 0)
    c.close()


def fr_mul(a, b):
    """a * b / 2^256 mod p: a < 2^256 - p, any b; below a * b / 2^256 + p."""
    av, bv = value(a), value(b)
    assert av < R - FR, "fr_mul takes a < 2^256 - p"
    e, o = [0] * N, [0] * N
    mul_row(e, a, 0, b[0])
    mul_row(o, a, 1, b[0])
    redc_step(e, o)
    for i in range(1, N):  # the accumulators swap roles every row
        if i % 2:
            mul_step(o, e, a, b[i])
        else:
            mul_step(e, o, a, b[i])
    merge(e, o)
    r = value(e)
    assert r % FR == av * bv * pow(R, -1, FR) % FR
    assert r * R < av * bv + FR * R, "fr_mul above a * b / 2^256 + p"
    return e


def col_mac(t, x, y):
    c = Chain()
    t[0] = c.mad_lo_cc(x, y, t[0])
    t[1] = c.madc_hi_cc(x, y, t[1])
    t[2] = c.addc(t[2], 0)
    c.close()


def col_finish(t, c0, c1, x=None):
    c = Chain()
    t[0] = c.add_cc(t[0], t[0])
    t[1] = c.addc_cc(t[1], t[1])
    t[2] = c.addc(t[2], t[2])
    t[0] = c.add_cc(t[0], c0)
    t[1] = c.addc_cc(t[1], c1)
    t[2] = c.addc(t[2], 0)
    c.close()
    if x is not None:
        c = Chain()
        t[0] = c.mad_lo_cc(x, x, t[0])
        t[1] = c.madc_hi_cc(x, x, t[1])
        t[2] = c.addc(t[2], 0)
        c.close()


def sqr_wide(a):
    w = [0] * (2 * N)
    c0 = c1 = 0
    for k in range(2 * N - 1):
        t = [0, 0, 0]
        lo = 0 if k < N else k - N + 1
        i = lo
        while 2 * i < k:
            if i == lo:
                p = a[i] * a[k - i]
                t[0], t[1] = p & M32, p >> 32
            else:
                col_mac(t, a[i], a[k - i])
            i += 1
        col_finish(t, c0, c1, a[k // 2] if k % 2 == 0 else None)
        w[k] = t[0]
        c0, c1 = t[1], t[2]
    assert c1 == 0
    w[2 * N - 1] = c0
    assert value(w) == value(a) ** 2
    return w


def shift_step(e, o):
    assert o[0] == 0, "the window move drops a word that is not zero"
    c = Chain()
    e[0] = c.add_cc(e[0], o[1])
    for j in range(0, 6):
        o[j] = c.addc_cc(o[j + 2], 0)
    o[6] = c.addc(0, 0)
    c.close()
    o[7] = 0


def redc_low(e):
    """x / 2^256 mod p for x < 2^256, in place: gives [0, p], and p exactly
    when x is a nonzero multiple of p."""
    x = value(e)
    o = [0] * N
    redc_step(e, o)
    for i in range(1, N):
        if i % 2:
            shift_step(o, e)
            redc_step(o, e)
        else:
            shift_step(e, o)
            redc_step(e, o)
    merge(e, o)
    r = value(e)
    assert r % FR == x * pow(R, -1, FR) % FR
    assert r <= FR and (r == FR) == (x > 0 and x % FR == 0)


def add_to(r, x):
    c = Chain()
    r[0] = c.add_cc(r[0], x[0])
    for j in range(1, N - 1):
        r[j] = c.addc_cc(r[j], x[j])
    r[7] = c.addc(r[7], x[7])
    c.close()


def fr_sqr(a):
    """a * a / 2^256 mod p: a * a < 2^256 (p - 1); below a * a / 2^256 + p + 1."""
    av = value(a)
    assert av * av < R * (FR - 1), "fr_sqr takes a < 2.3p"
    w = sqr_wide(a)
    lo = w[:N]
    redc_low(lo)
    add_to(lo, w[N:])
    r = value(lo)
    assert r % FR == av * av * pow(R, -1, FR) % FR
    assert r * R < av * av + (FR + 1) * R
    return lo


def add_limbs(a, b):
    c = Chain()
    s = [c.add_cc(a[0], b[0])]
    for j in range(1, N - 1):
        s.append(c.addc_cc(a[j], b[j]))
    s.append(c.addc(a[7], b[7]))
    c.close()
    return s


def sub_limbs(s, m):
    c = Chain()
    d = [c.sub_cc(s[0], m[0])]
    for j in range(1, N):
        d.append(c.subc_cc(s[j], m[j]))
    borrow = c.borrow_mask(0)
    c.close()
    return d, borrow


def cond_sub(s, m):
    d, keep = sub_limbs(s, m)
    return [(sj & keep) | (dj & ~keep & M32) for sj, dj in zip(s, d)]


def fr_add(a, b):
    """a + b below 2p: a + b < 4p."""
    av, bv = value(a), value(b)
    assert av + bv < 4 * FR, "fr_add takes a + b < 4p"
    r = cond_sub(add_limbs(a, b), Q_L)
    assert value(r) < 2 * FR and value(r) % FR == (av + bv) % FR
    return r


def fr_reduce(x):
    assert value(x) < 2 * FR
    r = cond_sub(x, P_L)
    assert value(r) == value(x) % FR
    return r


def fr_from_mont(x):
    r = list(x)
    redc_low(r)
    return r


# --- the kernel's structure (csrc/poseidon2_bn254.cu) ------------------------

def _mont(v):
    return limbs(v * R % FR)


def _constants():
    ext0, internal, ext1, diag = tp2b.round_constants()
    return ([[_mont(c) for c in rc] for rc in ext0 + ext1],
            [_mont(c) for c in internal], [_mont(d) for d in diag],
            limbs(R * R % FR))


EXT, INTERNAL, DIAG, R2 = _constants()


def _in_range(x):
    assert value(x) < 2 * FR, "a lane left [0, 2p)"
    return x


def to_mont(x):
    return _in_range(fr_mul(x, R2))


def sbox(x):
    x2 = _in_range(fr_sqr(x))
    x4 = _in_range(fr_sqr(x2))
    return _in_range(fr_mul(x4, x))


def external_linear(s):
    tot = fr_add(fr_add(s[0], s[1]), s[2])
    return [fr_add(v, tot) for v in s]


def full_round(s, r):
    s = list(s)
    for i in range(3):  # one S-box per trip, the lanes turning round
        x = sbox(fr_add(s[0], EXT[r][i]))
        s = [s[1], s[2], x]
    return external_linear(s)


def partial_round(s, r):
    y1 = fr_mul(s[1], DIAG[1])
    y2 = fr_mul(s[2], DIAG[2])
    x = sbox(fr_add(s[0], INTERNAL[r]))
    tot = fr_add(fr_add(x, s[1]), s[2])
    return [fr_add(fr_mul(x, DIAG[0]), tot), fr_add(y1, tot),
            fr_add(y2, tot)]


def permute(s):
    s = external_linear(s)
    for r in range(4):
        s = full_round(s, r)
    for r in range(56):
        s = partial_round(s, r)
    for r in range(4, 8):
        s = full_round(s, r)
    return [_in_range(v) for v in s]


def digest(x):
    return value(fr_reduce(fr_from_mont(x)))


def hash_row(row):
    """The rows kernel's sponge on one row of canonical Goldilocks values."""
    n_fr = (len(row) + 2) // 3
    s = [[0] * N for _ in range(3)]
    for blk in range((n_fr + 1) // 2):
        for lane in range(2):
            v = [0] * N
            for j in range(3):
                col = 3 * (2 * blk + lane) + j
                if col < len(row):
                    v[2 * j], v[2 * j + 1] = row[col] & M32, row[col] >> 32
            s[lane] = to_mont(v)
        s = permute(s)
    return digest(s[0])


# --- tests -------------------------------------------------------------------

THIRD = R // 3  # about 1.76p
EDGES = [0, 1, FR - 1, FR, FR + 1, 2 * FR - 1, THIRD - 1, THIRD, THIRD + 1]


def _uniform(rng, k, bound):
    words = rng.integers(0, 1 << 63, size=(k, 5), dtype=np.int64).tolist()
    return [sum(int(w) << (63 * j) for j, w in enumerate(ws)) % bound
            for ws in words]


def test_constants_are_the_headers():
    header = os.path.join(os.path.dirname(__file__), "..",
                          "zkevm_harness_tpu_torch", "csrc", "bn254_fr.cuh")
    with open(header) as f:
        src = f.read()
    for name, v in ([(f"P{j}", w) for j, w in enumerate(P_L)]
                    + [(f"Q{j}", w) for j, w in enumerate(Q_L)]
                    + [("M0", M0)]):
        assert f"{name} = 0x{v:08x}u" in src, name
    assert 5 * FR < R < 6 * FR


def test_fr_mul_at_the_extremes():
    for x in EDGES:
        for y in EDGES:
            r = value(fr_mul(limbs(x), limbs(y)))
            assert r < 2 * FR  # both below 2p
    # the widest inputs the header admits: a < 2^256 - p with any b, and
    # a < 4p with b <= p (the diagonal's case) staying below 2p
    for a in (R - FR - 1, 4 * FR - 1, 3 * FR + 12345):
        for b in (0, 1, FR - 1, FR, R - 1):
            r = value(fr_mul(limbs(a), limbs(b)))
            if a < 4 * FR and b <= FR:
                assert r < 2 * FR


def test_fr_mul_random():
    rng = np.random.default_rng(2541)
    xs, ys = _uniform(rng, 300, 2 * FR), _uniform(rng, 300, 2 * FR)
    for x, y in zip(xs, ys):
        assert value(fr_mul(limbs(x), limbs(y))) < 2 * FR


def test_fr_sqr_at_the_extremes_and_random():
    widest = int(np.floor(np.sqrt(float(R * (FR - 1)))))
    while widest * widest >= R * (FR - 1):
        widest -= 1
    for x in EDGES + [widest, widest - 1, (1 << 128) - 1, 1 << 128]:
        r = value(fr_sqr(limbs(x)))
        if x < 2 * FR:
            assert r < 2 * FR
    for x in _uniform(np.random.default_rng(2542), 300, 2 * FR):
        assert value(fr_sqr(limbs(x))) < 2 * FR


def test_fr_add_reduce_and_from_mont():
    for x in EDGES + [2 * FR - 2]:
        for y in EDGES + [2 * FR - 2]:
            fr_add(limbs(x), limbs(y))  # asserts the range and the sum
    fr_add(limbs(3 * FR), limbs(FR - 1))  # a + b = 4p - 1, the widest
    for x in EDGES:
        fr_reduce(limbs(x))
    for x in EDGES + [R - 1, 2 * FR + 5, 2 * FR, 3 * FR, 4 * FR, 5 * FR]:
        r = value(fr_from_mont(limbs(x)))
        assert r <= FR and (r == FR) == (x > 0 and x % FR == 0)
        assert value(fr_reduce(fr_from_mont(limbs(x)))) == \
            x * pow(R, -1, FR) % FR


@pytest.mark.parametrize("which", ["zero", "top", "random"])
def test_permutation_through_the_model_equals_the_host(which):
    state = {"zero": [0, 0, 0], "top": [FR - 1] * 3,
             "random": _uniform(np.random.default_rng(2543), 3, FR)}[which]
    got = permute([to_mont(limbs(v)) for v in state])
    want = tp2b.permute(state)
    assert [digest(v) for v in got] == want == jp2b.permute(state)


def test_row_sponge_through_the_model_equals_the_host():
    rng = np.random.default_rng(2544)
    row = rng.integers(0, GL_P, size=72, dtype=np.uint64).tolist()
    row[:4] = [GL_P - 1, 0, GL_P - 1, GL_P - 1]
    packed = tp2b.pack_goldilocks(row)
    assert hash_row([int(v) for v in row]) == tp2b.hash_elements(packed) \
        == jp2b.hash_elements(jhb.Bn254Backend.pack_row(row))
