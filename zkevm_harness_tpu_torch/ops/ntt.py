"""NTT / inverse NTT / coset LDE over Goldilocks, batched (PyTorch).

Counterpart of the JAX package's `ops/ntt.py`. The transform runs over the
LAST axis and is batched over all leading axes, so a (num_cols, N) trace does
all columns at once. Outputs are exact field values, so any correct algorithm
agrees with the reference bit for bit; this one is a plain iterative radix-2
DIT (bit-reversal gather, then one butterfly pass per stage) built on the
field kernels: t = w * odd; (even + t, even - t).
"""

from __future__ import annotations

import torch

from . import goldilocks as gl
from .goldilocks import GF, P


_REV_CACHE: dict = {}


def bit_reverse_indices(n: int, device) -> torch.Tensor:
    """int64 index tensor rev with rev[i] = i with its log2(n) bits reversed,
    built on `device` and cached per (n, device)."""
    device = torch.device(device)
    key = (n, device.type, device.index)
    if key not in _REV_CACHE:
        log_n = n.bit_length() - 1
        assert 1 << log_n == n
        idx = torch.arange(n, dtype=torch.int64, device=device)
        rev = torch.zeros_like(idx)
        for b in range(log_n):
            rev |= ((idx >> b) & 1) << (log_n - 1 - b)
        _REV_CACHE[key] = rev
    return _REV_CACHE[key]


# Rows of one transform pass: a pass holds a few copies of its block, so
# wide traces (the log demuxer's 9,894 columns) go through in blocks of at
# most this many elements (2 GiB of int64)
_BLOCK_ELEMS = 1 << 28


def _row_blocks(rows: int, n: int):
    step = max(1, _BLOCK_ELEMS // n)
    return [(r, min(rows, r + step)) for r in range(0, rows, step)]


def _ntt_core(values: GF, log_n: int, inverse: bool) -> GF:
    """Iterative radix-2 DIT over the last axis, natural order in and out,
    in blocks of rows (`_BLOCK_ELEMS`)."""
    n = 1 << log_n
    if log_n == 0:
        return values.clone()
    shape = values.shape
    x = values.reshape(-1, n)
    blocks = _row_blocks(x.shape[0], n)
    if len(blocks) == 1:
        return _ntt_rows(x, log_n, inverse).reshape(shape)
    out = torch.empty_like(x)
    for r0, r1 in blocks:
        out[r0:r1] = _ntt_rows(x[r0:r1], log_n, inverse)
    return out.reshape(shape)


def _ntt_rows(x: GF, log_n: int, inverse: bool) -> GF:
    """`_ntt_core` on one (rows, n) block."""
    n = 1 << log_n
    rows = x.shape[0]
    x = torch.index_select(x, 1, bit_reverse_indices(n, x.device))
    w = gl.primitive_root_of_unity(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    # w^i for i < n/2; stage s (butterfly span 2^s) reads every
    # (n / 2^(s+1))-th entry
    table = gl.powers_dev_cached(w, n // 2, device=x.device)
    for s in range(log_n):
        half = 1 << s
        groups = n >> (s + 1)
        x4 = x.view(rows, groups, 2, half)
        even = x4[:, :, 0, :].contiguous()
        odd = x4[:, :, 1, :]
        t = odd.contiguous() if s == 0 else gl.mul(odd, table[::groups])
        x = torch.stack([gl.add(even, t), gl.sub(even, t)],
                        dim=2).reshape(rows, n)
    return x


def ntt(values: GF) -> GF:
    """Coefficients -> evaluations on the order-n subgroup (natural order)."""
    n = values.shape[-1]
    assert n & (n - 1) == 0, f"NTT length must be a power of two, got {n}"
    return _ntt_core(values, n.bit_length() - 1, False)


def intt(values: GF) -> GF:
    """Evaluations on the subgroup -> coefficients."""
    n = values.shape[-1]
    assert n & (n - 1) == 0, f"NTT length must be a power of two, got {n}"
    out = _ntt_core(values, n.bit_length() - 1, True)
    return gl.mul_scalar(out, pow(n, P - 2, P))


def powers_device(base_arr: GF, n: int) -> GF:
    """[1, b, b^2, ..., b^(n-1)] via log-doubling on the device of the scalar
    field tensor `base_arr`."""
    assert n & (n - 1) == 0
    b = base_arr.reshape(1)
    cur = torch.ones(1, dtype=torch.int64, device=b.device)
    step = b  # b^len(cur)
    while cur.shape[0] < n:
        cur = torch.cat([cur, gl.mul(cur, step)])
        step = gl.sqr(step)
    return cur


def scale_by_powers(values: GF, base: int) -> GF:
    """values[..., i] * base^i (coset shift of coefficients)."""
    n = values.shape[-1]
    return gl.mul(values, gl.powers_dev_cached(base, n, device=values.device))


def lde_from_coeffs(coeffs: GF, big_n: int,
                    shift: int = gl.MULTIPLICATIVE_GENERATOR) -> GF:
    """Evaluations of (..., n) coefficient rows on the coset shift * K of the
    size-big_n subgroup K, natural order (in blocks of rows, as `_ntt_core`,
    so that the padded and scaled copies exist for one block at a time)."""
    n = coeffs.shape[-1]
    x = coeffs.reshape(-1, n)
    out = torch.empty((x.shape[0], big_n), dtype=torch.int64,
                      device=coeffs.device)
    for r0, r1 in _row_blocks(x.shape[0], big_n):
        pad = torch.zeros((r1 - r0, big_n - n), dtype=torch.int64,
                          device=coeffs.device)
        out[r0:r1] = ntt(scale_by_powers(torch.cat([x[r0:r1], pad], dim=-1),
                                         shift))
    return out.reshape(coeffs.shape[:-1] + (big_n,))


def coset_lde(evals: GF, lde_factor: int,
              shift: int = gl.MULTIPLICATIVE_GENERATOR) -> GF:
    """Low-degree extend evaluations on H (size n) to the coset shift * K of
    the size n * lde_factor subgroup K. Returns (..., n * lde_factor)."""
    n = evals.shape[-1]
    return lde_from_coeffs(intt(evals), n * lde_factor, shift)


def ext_powers_device(x: gl.GF2, n: int) -> gl.GF2:
    """[1, x, ..., x^(n-1)] for a scalar extension point, via log-doubling."""
    assert n & (n - 1) == 0 and n >= 1
    x1 = gl.GF2(x.c0.reshape(1), x.c1.reshape(1))
    cur = gl.GF2(torch.ones_like(x1.c0), torch.zeros_like(x1.c1))
    step = x1  # x^len(cur)
    while cur.c0.shape[0] < n:
        cur = gl.ext_concat([cur, gl.ext_mul(cur, step)])
        step = gl.ext_sqr(step)
    return cur


def eval_poly_at(coeffs: GF, x: gl.GF2) -> gl.GF2:
    """Evaluate base-field polynomial(s) at an extension point.

    coeffs: (..., n); x: scalar GF2. Returns (...,) GF2: sum_i c_i x^i as
    powers * coeffs, then a log-depth tree sum."""
    n = coeffs.shape[-1]
    pws = ext_powers_device(x, n)
    terms = gl.GF2(gl.mul(coeffs, pws.c0), gl.mul(coeffs, pws.c1))
    return gl.ext_sum_axis(terms, axis=-1)
