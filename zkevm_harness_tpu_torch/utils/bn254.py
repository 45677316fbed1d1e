"""BN254 (alt_bn128): fields, G1/G2, pairing, MSM, FFT domain, KZG.

The SNARK wrapper proves the final compression proof in a Bn254 PLONK circuit
(reference: bellman_ce assemblies, src/proof_wrapper_utils/wrapper.rs,
L1_VERIFIER_DOMAIN_SIZE_LOG = 24). This module provides the exact host-side
curve/field layer the wrapper (utils/plonk.py) runs on: G1/G2 arithmetic,
Pippenger MSM over a CRS, the Fr FFT domain (2-adicity 28), and the optimal
ate pairing over the D-twist tower Fp2 = Fp[u]/(u^2+1),
Fp12 = Fp2[w]/(w^6 - xi) with xi = 9 + u. Final exponentiation is one big
pow (correctness-first, same style as utils/bls12_381.py — the wrapper runs
once per block on the host, off the card's hot path, exactly like the
reference keeps its wrapper on CPU).

Counterpart of the JAX package's `utils/bn254.py`, moved across as it is
(host Python ints; the MSM routes to the native library of `cpp/` through
`utils/native.py`)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# base and scalar fields
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FR_TWO_ADICITY = 28
FR_GENERATOR = 5

G1_GENERATOR = (1, 2)
B = 3  # y^2 = x^3 + 3


def fr_root_of_unity(log_n: int) -> int:
    assert log_n <= FR_TWO_ADICITY
    base = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    for _ in range(FR_TWO_ADICITY - log_n):
        base = base * base % R
    return base


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


# -- Jacobian fast path (CRS generation) -------------------------------------
# Affine adds pay a ~15 us field inversion each; generating a 2^19-point CRS
# that way costs hours. Jacobian doubling/addition (no inversions) plus ONE
# batch normalization brings it to minutes.

def _jac_dbl(p):
    x, y, z = p
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _jac_add(p, q2):
    if p is None:
        return q2
    if q2 is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q2
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        if (s1 + s2) % Q == 0:
            return None
        return _jac_dbl(p)
    h = (u2 - u1) % Q
    i = (2 * h) * (2 * h) % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % Q * h % Q
    return (x3, y3, z3)


def _jac_mul(p, k: int):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = _jac_add(acc, p)
        p = _jac_dbl(p)
        k >>= 1
    return acc


def _jac_batch_affine(points) -> List:
    """Batch-normalize Jacobian points with ONE inversion (Montgomery)."""
    zs = [p[2] if p is not None else 1 for p in points]
    prefix = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % Q
    inv_all = pow(prefix[-1], Q - 2, Q)
    out: List = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z_inv = prefix[i] * inv_all % Q
        inv_all = inv_all * zs[i] % Q
        p = points[i]
        if p is None:
            continue
        zi2 = z_inv * z_inv % Q
        out[i] = (p[0] * zi2 % Q, p[1] * zi2 * z_inv % Q)
    return out


def g1_mul(p, k: int):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


def g1_msm(points: Sequence, scalars: Sequence[int], window_bits: int = 8):
    """Pippenger bucket MSM. Routes to the native C++ kernel
    (cpp/bn254_msm.cpp, 4x64 Montgomery limbs + Jacobian buckets) when the
    library is available — the SNARK wrapper's KZG commitments/openings are
    MSM-bound; pure-Python Pippenger below stays as the fallback (and the
    cross-check oracle in tests). Unlike the JAX package, which keeps
    inputs under 16 points in Python, the native kernel takes every
    non-empty input, so that a run shows which MSM it used (the values
    are the same)."""
    if points:
        try:
            from .native import bn254_msm as _native_msm
            scalars_red = [int(s) % R for s in scalars]
            return _native_msm(list(points), scalars_red)
        except (RuntimeError, OSError):
            pass
    acc = None
    n_windows = (254 + window_bits - 1) // window_bits
    mask = (1 << window_bits) - 1
    for w in reversed(range(n_windows)):
        if acc is not None:
            for _ in range(window_bits):
                acc = g1_add(acc, acc)
        buckets = {}
        for pt, s in zip(points, scalars):
            if pt is None:
                continue
            digit = (int(s) >> (w * window_bits)) & mask
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


def fr_fft(poly: Sequence[int]) -> List[int]:
    """Monomial -> evaluations on the 2^k subgroup (the wrapper's 2^24 domain
    in production; any power of two here)."""
    n = len(poly)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    w = fr_root_of_unity(log_n)
    a = list(poly)
    rev = [int(format(i, f"0{log_n}b")[::-1], 2) for i in range(n)]
    a = [a[rev[i]] for i in range(n)]
    size = 2
    while size <= n:
        wm = pow(w, n // size, R)
        for start in range(0, n, size):
            wk = 1
            for j in range(size // 2):
                u = a[start + j]
                t = a[start + j + size // 2] * wk % R
                a[start + j] = (u + t) % R
                a[start + j + size // 2] = (u - t) % R
                wk = wk * wm % R
        size *= 2
    return a


_CRS_MEM: dict = {}


def simulated_crs(max_degree: int, tau: int = 0xACE0FBA5E) -> List:
    """[tau^i]G1 powers for tests (the production CRS loads from the
    reference's CRS_FILE, utils.rs get_trusted_setup). Disk-cached: the
    in-SNARK FRI wrapper pads to 2^18+ gates and regenerating that many
    G1 scalar muls in python costs minutes per run."""
    import os
    import pickle
    if tau in _CRS_MEM and len(_CRS_MEM[tau]) >= max_degree:
        return _CRS_MEM[tau][:max_degree]
    cache_dir = os.path.join(os.path.dirname(__file__), "..", "..",
                             ".crs_cache")
    path = os.path.join(cache_dir, f"crs_{tau:x}.pkl")
    cached: List = []
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                cached = pickle.load(f)
        except Exception:
            cached = []
    if len(cached) < max_degree:
        out = list(cached)
        # Jacobian chain: crs[i+1] = [tau] crs[i] with a fixed-window ladder
        # over tau (the scalar is FIXED, so precompute its NAF once), then
        # one batch normalization — minutes instead of hours at 2^19.
        start = len(out)
        cur = (_jac_mul((G1_GENERATOR[0], G1_GENERATOR[1], 1),
                        pow(tau, start, R)) if start
               else (G1_GENERATOR[0], G1_GENERATOR[1], 1))
        jac_out = [cur]
        tau_bits = [int(b) for b in bin(tau % R)[2:]]
        for _ in range(max_degree - start - 1):
            acc = None
            for b in tau_bits:
                acc = _jac_dbl(acc) if acc is not None else None
                if b:
                    acc = _jac_add(acc, cur)
            cur = acc
            jac_out.append(cur)
        out.extend(_jac_batch_affine(jac_out))
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(out, f)
        except OSError:
            pass
        cached = out
    _CRS_MEM[tau] = cached
    return cached[:max_degree]


def kate_commit(crs: Sequence, coeffs: Sequence[int]):
    """Polynomial commitment [p(tau)]G1 over the monomial CRS."""
    return g1_msm(crs[:len(coeffs)], list(coeffs))


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2 + 1)
# ---------------------------------------------------------------------------

XI = (9, 1)  # 9 + u, the sextic non-residue (D-twist divisor)
BN_U = 4965661367192848881  # the BN parameter x
ATE_LOOP = 6 * BN_U + 2


def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scale(a, c):
    return (a[0] * c % Q, a[1] * c % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def f2_conj(a):
    return (a[0], (-a[1]) % Q)


def f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, Q - 2, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


def f2_pow(a, e: int):
    result = (1, 0)
    while e:
        if e & 1:
            result = f2_mul(result, a)
        a = f2_sqr(a)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Fp12 = Fp2[w]/(w^6 - xi): 6 Fp2 coefficients, low to high
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


def f12_pow(a, e: int):
    result = F12_ONE
    while e:
        if e & 1:
            result = f12_mul(result, a)
        a = f12_sqr(a)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# G2 (affine over Fp2, the D-twist E': y^2 = x^3 + 3/xi)
# ---------------------------------------------------------------------------

B2 = f2_mul((B, 0), f2_inv(XI))

G2_GENERATOR = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


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


# Frobenius constants for the twisted-coordinate endomorphism:
# pi_p(x, y) = (conj(x) * xi^((p-1)/3), conj(y) * xi^((p-1)/2))
_FROB_X = f2_pow(XI, (Q - 1) // 3)
_FROB_Y = f2_pow(XI, (Q - 1) // 2)


def g2_frobenius(p):
    if p is None:
        return None
    x, y = p
    return (f2_mul(f2_conj(x), _FROB_X), f2_mul(f2_conj(y), _FROB_Y))


# ---------------------------------------------------------------------------
# Pairing (optimal ate over 6u+2, D-twist line evaluation)
# ---------------------------------------------------------------------------

def _f12_at(c, power_of_w: int):
    out = [(0, 0)] * 6
    out[power_of_w] = c
    return tuple(out)


def _line(t, q2, p1):
    """Line through the untwisted images of t and (q2 or t for doubling),
    evaluated at p1 = (xp, yp) in G1.

    Untwisting psi(x, y) = (x*w^2, y*w^3) gives slope lam' = lam*w and
    l(P) = yp - lam*xp * w + (lam*x_T - y_T) * w^3.
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
    val = [(0, 0)] * 6
    val[0] = (yp % Q, 0)
    val[1] = f2_scale(lam, (-xp) % Q)
    val[3] = f2_sub(f2_mul(lam, xt), yt)
    return tuple(val), t_new


def miller_loop(p1, q2):
    if p1 is None or q2 is None:
        return F12_ONE
    f = F12_ONE
    t = q2
    for b in bin(ATE_LOOP)[3:]:  # skip leading 1
        ln, t = _line(t, None, p1)
        f = f12_mul(f12_sqr(f), ln)
        if b == "1":
            ln, t = _line(t, q2, p1)
            f = f12_mul(f, ln)
    # BN final steps: two more line additions with Frobenius images of Q
    q1 = g2_frobenius(q2)
    q2f = g2_neg(g2_frobenius(q1))
    ln, t = _line(t, q1, p1)
    f = f12_mul(f, ln)
    ln, t = _line(t, q2f, p1)
    f = f12_mul(f, ln)
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def pairing(p1, q2):
    """e(P, Q) for P in G1, Q in G2 (full final exponentiation)."""
    return f12_pow(miller_loop(p1, q2), _FINAL_EXP)


def pairings_equal(pairs_a, pairs_b) -> bool:
    """prod e(a_i) == prod e(b_i) via one combined final exponentiation."""
    f = F12_ONE
    for (p, q) in pairs_a:
        f = f12_mul(f, miller_loop(p, q))
    for (p, q) in pairs_b:
        f = f12_mul(f, miller_loop(p, g2_neg(q)))
    return f12_pow(f, _FINAL_EXP) == F12_ONE


# ---------------------------------------------------------------------------
# KZG over the monomial CRS
# ---------------------------------------------------------------------------

def simulated_crs_g2(tau: int = 0xACE0FBA5E):
    """([1]G2, [tau]G2) for tests (production loads the reference CRS_FILE,
    utils.rs get_trusted_setup)."""
    return (G2_GENERATOR, g2_mul(G2_GENERATOR, tau))


def kate_open(crs: Sequence, coeffs: Sequence[int], z: int):
    """Witness [q(tau)]G1 for q(X) = (p(X) - p(z)) / (X - z); returns
    (witness, p(z))."""
    z %= R
    y = 0
    for c in reversed(list(coeffs)):
        y = (y * z + c) % R
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in reversed(range(1, len(coeffs))):
        carry = (coeffs[i] + carry * z) % R
        q[i - 1] = carry
    w = g1_msm(crs[:len(q)], q) if q else None
    return w, y


def kate_verify(g2_powers, commitment, z: int, y: int, witness) -> bool:
    """e(C - [y]G1, G2) == e(W, [tau]G2 - [z]G2)."""
    g2_one, g2_tau = g2_powers
    lhs = g1_add(commitment, g1_neg(g1_mul(G1_GENERATOR, y % R)))
    rhs_g2 = g2_add(g2_tau, g2_neg(g2_mul(g2_one, z % R)))
    return pairings_equal([(lhs, g2_one)], [(witness, rhs_g2)])
