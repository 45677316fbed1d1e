"""BLS12-381: fields, curve groups, pairing — exact python-int implementation.

The replacement for the reference `kzg` crate's dependency on bellman's
BLS12-381 (kzg/src/lib.rs:10), and the correctness anchor of the blob
branch: the commitment MSM runs in the native library of `cpp/`
(`utils/native.py`), verification (pairings) stays host-side exactly as the
reference keeps it on CPU. Counterpart of the JAX package's
`utils/bls12_381.py`, moved across as it is.

Tower: Fp2 = Fp[u]/(u^2+1); Fp12 = Fp2[w]/(w^6 - xi), xi = u+1 (the M-twist
E': y^2 = x^3 + 4*xi untwists via x/w^2, y/w^3). Pairing is the optimal ate
Miller loop over |x|, x = -0xd201000000010000, with the final exponentiation
done as one big pow (correctness-first; cyclotomic chains are a perf upgrade).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# field / curve parameters
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # scalar field
BLS_X = 0xD201000000010000  # |x|; the BLS parameter is -x
G1_B = 4

G1_GENERATOR = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GENERATOR = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

# Fr roots of unity: 2-adicity 32, generator 7
FR_TWO_ADICITY = 32
FR_GENERATOR = 7


def fr_root_of_unity(log_n: int) -> int:
    base = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    for _ in range(FR_TWO_ADICITY - log_n):
        base = base * base % R
    return base


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scale(a, c):
    return (a[0] * c % Q, a[1] * c % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, Q - 2, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


def f2_pow(a, e):
    result = (1, 0)
    while e:
        if e & 1:
            result = f2_mul(result, a)
        a = f2_sqr(a)
        e >>= 1
    return result


def f2_sqrt(a) -> Optional[Tuple[int, int]]:
    """Square root in Fp2 (q ≡ 3 mod 4 algorithm); None if non-residue."""
    if a == (0, 0):
        return (0, 0)
    a1 = f2_pow(a, (Q - 3) // 4)
    alpha = f2_mul(f2_sqr(a1), a)
    x0 = f2_mul(a1, a)
    if alpha == ((-1) % Q, 0):
        x = (Q - x0[1] if x0[1] else 0, x0[0])  # i * x0
    else:
        b = f2_pow(f2_add((1, 0), alpha), (Q - 1) // 2)
        x = f2_mul(b, x0)
    return x if f2_sqr(x) == a else None


XI = (1, 1)  # u + 1, the sextic non-residue


# ---------------------------------------------------------------------------
# Fp12 = Fp2[w]/(w^6 - xi): 6 Fp2 coefficients (low to high)
# ---------------------------------------------------------------------------

F12_ONE = ((1, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0))


def f12_mul(a, b):
    acc = [(0, 0)] * 11
    for i in range(6):
        if a[i] == (0, 0):
            continue
        for j in range(6):
            if b[j] == (0, 0):
                continue
            acc[i + j] = f2_add(acc[i + j], f2_mul(a[i], b[j]))
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul(acc[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """Conjugation by the p^6 Frobenius: negate odd coefficients of w."""
    return tuple(c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(a))


def f12_pow(a, e):
    result = F12_ONE
    while e:
        if e & 1:
            result = f12_mul(result, a)
        a = f12_sqr(a)
        e >>= 1
    return result


def f12_inv(a):
    return f12_pow(a, Q ** 12 - 2)


# ---------------------------------------------------------------------------
# G1 (Jacobian over Fp)
# ---------------------------------------------------------------------------

INF1 = None


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - G1_B) % Q == 0


def g1_double(p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = (3 * x * x) * pow(2 * y, Q - 2, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    y3 = (lam * (x - x3) - y) % Q
    return (x3, y3)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % Q == 0:
            return None
        return g1_double(p)
    lam = (q[1] - p[1]) * pow(q[0] - p[0], Q - 2, Q) % Q
    x3 = (lam * lam - p[0] - q[0]) % Q
    y3 = (lam * (p[0] - x3) - p[1]) % Q
    return (x3, y3)


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_mul(p, k: int):
    k %= R
    result = None
    while k:
        if k & 1:
            result = g1_add(result, p)
        p = g1_double(p)
        k >>= 1
    return result


def g1_msm(points: List, scalars: List[int]):
    """Pippenger bucket MSM. Routes to the native C++ kernel
    (cpp/bn254_msm.cpp bls12381_msm: 6x64 Montgomery limbs) when available
    — the EIP-4844 KZG commitment hot loop (reference rayon MSM,
    kzg/src/lib.rs:195-217); pure-Python Pippenger stays as fallback and
    test oracle. The native kernel takes every non-empty input (the JAX
    package keeps inputs under 16 points in Python; the values are the
    same)."""
    if points:
        try:
            from .native import bls12381_msm as _native_msm
            return _native_msm(list(points), [int(s) % R for s in scalars])
        except (RuntimeError, OSError):
            pass
    c = 8  # window bits
    acc = None
    n_windows = (255 + c - 1) // c
    for w in reversed(range(n_windows)):
        if acc is not None:
            for _ in range(c):
                acc = g1_double(acc)
        buckets: dict = {}
        for pt, s in zip(points, scalars):
            if pt is None:
                continue
            digit = (s >> (w * c)) & ((1 << c) - 1)
            if digit:
                buckets[digit] = g1_add(buckets.get(digit), pt)
        running = None
        window_sum = None
        max_digit = max(buckets.keys(), default=0)
        for digit in range(max_digit, 0, -1):
            b = buckets.get(digit)
            if b is not None:
                running = g1_add(running, b)
            window_sum = g1_add(window_sum, running)
        acc = g1_add(acc, window_sum)
    return acc


# ---------------------------------------------------------------------------
# G2 (affine over Fp2)
# ---------------------------------------------------------------------------

B2 = f2_scale(XI, G1_B)  # 4*(u+1)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == (0, 0)


def g2_double(p):
    if p is None:
        return None
    x, y = p
    if y == (0, 0):
        return None
    lam = f2_mul(f2_scale(f2_sqr(x), 3), f2_inv(f2_scale(y, 2)))
    x3 = f2_sub(f2_sqr(lam), f2_scale(x, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x, x3)), y)
    return (x3, y3)


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if f2_add(p[1], q[1]) == (0, 0):
            return None
        return g2_double(p)
    lam = f2_mul(f2_sub(q[1], p[1]), f2_inv(f2_sub(q[0], p[0])))
    x3 = f2_sub(f2_sub(f2_sqr(lam), p[0]), q[0])
    y3 = f2_sub(f2_mul(lam, f2_sub(p[0], x3)), p[1])
    return (x3, y3)


def g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]))


def g2_mul(p, k: int):
    k %= R
    result = None
    while k:
        if k & 1:
            result = g2_add(result, p)
        p = g2_double(p)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# Point (de)compression — zcash/ethereum serialization
# ---------------------------------------------------------------------------

def g1_decompress(data: bytes):
    assert len(data) == 48
    flags = data[0]
    assert flags & 0x80, "not compressed"
    if flags & 0x40:
        return None  # infinity
    sign = (flags & 0x20) != 0
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    rhs = (x * x * x + G1_B) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    assert y * y % Q == rhs, "invalid x coordinate"
    if (y > Q - y) != sign:
        y = Q - y
    return (x, y)


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0]) + bytes(47)
    x, y = p
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= 0x80
    if y > Q - y:
        data[0] |= 0x20
    return bytes(data)


def g2_decompress(data: bytes):
    assert len(data) == 96
    flags = data[0]
    assert flags & 0x80, "not compressed"
    if flags & 0x40:
        return None
    sign = (flags & 0x20) != 0
    x_c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:], "big")
    x = (x_c0, x_c1)
    rhs = f2_add(f2_mul(f2_sqr(x), x), B2)
    y = f2_sqrt(rhs)
    assert y is not None, "invalid x coordinate"
    # lexicographic sign on (c1, c0)
    y_neg = f2_neg(y)
    greater = (y[1], y[0]) > (y_neg[1], y_neg[0])
    if greater != sign:
        y = y_neg
    return (x, y)


# ---------------------------------------------------------------------------
# Pairing (optimal ate)
# ---------------------------------------------------------------------------

def _f12_from_f2(c, power_of_w: int):
    out = [(0, 0)] * 6
    out[power_of_w] = c
    return tuple(out)


def _winv_constants():
    # w^-1 and w^-3 as Fp12 elements: w^-1 = w^5 / xi, w^-3 = w^3 / xi
    xi_inv = f2_inv(XI)
    w5 = _f12_from_f2(xi_inv, 5)
    w3 = _f12_from_f2(xi_inv, 3)
    return w5, w3


_WINV, _W3INV = _winv_constants()


def _line(t, q2, p1):
    """Line through untwisted t,(q2 if add else t) evaluated at p1 ∈ G1.

    Returns (f12_value, new_t). q2 None => doubling step.
    """
    xp, yp = p1
    xt, yt = t
    if q2 is None:
        lam = f2_mul(f2_scale(f2_sqr(xt), 3), f2_inv(f2_scale(yt, 2)))
        t_new = g2_double(t)
    else:
        xq, yq = q2
        lam = f2_mul(f2_sub(yq, yt), f2_inv(f2_sub(xq, xt)))
        t_new = g2_add(t, q2)
    # l(P) = y_P - lam*x_P/w + (lam*x_T - y_T)/w^3
    c0 = _f12_from_f2((yp % Q, 0), 0)
    c1 = f12_mul(_f12_from_f2(f2_scale(lam, (-xp) % Q), 0), _WINV)
    c2 = f12_mul(_f12_from_f2(f2_sub(f2_mul(lam, xt), yt), 0), _W3INV)
    val = tuple(f2_add(f2_add(a, b), c) for a, b, c in zip(c0, c1, c2))
    return val, t_new


def miller_loop(p1, q2):
    if p1 is None or q2 is None:
        return F12_ONE
    f = F12_ONE
    t = q2
    bits = bin(BLS_X)[3:]  # skip leading 1
    for b in bits:
        ln, t = _line(t, None, p1)
        f = f12_mul(f12_sqr(f), ln)
        if b == "1":
            ln, t = _line(t, q2, p1)
            f = f12_mul(f, ln)
    return f12_conj(f)  # BLS parameter is negative


_FINAL_EXP = (Q ** 12 - 1) // R


def pairing(p1, q2):
    """e(P, Q) for P ∈ G1, Q ∈ G2 (full final exponentiation)."""
    return f12_pow(miller_loop(p1, q2), _FINAL_EXP)


def pairings_equal(pairs_a, pairs_b) -> bool:
    """prod e(a_i) == prod e(b_i) via one combined check."""
    f = F12_ONE
    for (p, q) in pairs_a:
        f = f12_mul(f, miller_loop(p, q))
    for (p, q) in pairs_b:
        f = f12_mul(f, miller_loop(p, g2_neg(q)))
    return f12_pow(f, _FINAL_EXP) == F12_ONE
