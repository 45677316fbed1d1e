"""Exact python-int Goldilocks / Ext2 arithmetic for host-side verification.

The verifier's per-query scalar math (fold checks, final-poly evaluation,
constraint recomputation at OOD points) is tiny; doing it in exact integers
keeps it independent from the device kernels — the same role the reference's
out-of-circuit verifier plays against the prover (src/prover_utils.rs:351-362).
"""

from __future__ import annotations

P = 0xFFFFFFFF_00000001
W_EXT = 7  # extension non-residue, x^2 = 7


def fadd(a, b):
    return (a + b) % P


def fsub(a, b):
    return (a - b) % P


def fmul(a, b):
    return (a * b) % P


def finv(a):
    return pow(a, P - 2, P)


def eadd(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def esub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def emul(a, b):
    return ((a[0] * b[0] + W_EXT * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def escale(a, c):
    return ((a[0] * c) % P, (a[1] * c) % P)


def einv(a):
    norm = (a[0] * a[0] - W_EXT * a[1] * a[1]) % P
    ninv = finv(norm)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


def epow(a, e):
    result = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            result = emul(result, base)
        base = emul(base, base)
        e >>= 1
    return result


def eval_poly_ext(coeffs, x):
    """Horner eval of ext-coeff polynomial at ext point (list of (c0,c1))."""
    acc = (0, 0)
    for c in reversed(coeffs):
        acc = eadd(emul(acc, x), c)
    return acc
