"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on int64 PyTorch tensors.

Counterpart of the JAX package's `ops/goldilocks.py`. There an element is a
(lo, hi) pair of uint32 planes; here it is ONE int64 holding the canonical
u64 bit pattern (`GF` is just `torch.Tensor`), reinterpreted for free from
and to numpy `uint64` with `.view`. PyTorch has no unsigned 64-bit add, shift
or compare, so the plain versions in `cuda_kernels.py` spell the unsigned
semantics out; on a CUDA tensor `add`/`sub`/`mul`/`pow7` launch the
hand-written kernels instead.

The quadratic extension GF(p^2) = GF(p)[x]/(x^2 - 7) is a pair `GF2(c0, c1)`.
All public values are canonical (< p), so equality and serialisation are
well defined.

Functions that allocate take `device`: `None` means the CUDA card (raises
where there is none); pass `"cpu"` to stay on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from . import cuda_kernels as ck

P = 0xFFFFFFFF_00000001  # Goldilocks prime 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^64 mod p = 2^32 - 1
MULTIPLICATIVE_GENERATOR = 7  # generator of GF(p)^*, also ext non-residue
TWO_ADICITY = 32
EXT_NONRESIDUE = 7

GF = torch.Tensor  # int64, canonical u64 bit pattern


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device, or an error where there is none:
    the CPU is used only when a caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def _to_canonical_u64(values) -> np.ndarray:
    """Host: python ints / numpy integers -> canonical numpy uint64 (mod p)."""
    if isinstance(values, np.ndarray) and values.dtype in (np.uint64,
                                                           np.uint32):
        u = values.astype(np.uint64, copy=False)
    else:
        arr = np.asarray(values, dtype=object)
        try:
            u = arr.astype(np.uint64)
        except (OverflowError, TypeError, ValueError):
            u = None
        if u is None:
            flat = np.array([int(v) % P for v in arr.ravel()], dtype=object)
            return flat.astype(np.uint64).reshape(arr.shape)
    # any v < 2^64 is < 2p, so one conditional subtract canonicalises
    return np.where(u >= np.uint64(P), u - np.uint64(P), u)


def _u64_to_tensor(u: np.ndarray, device) -> GF:
    u = np.asarray(u, dtype=np.uint64)
    flat = np.ascontiguousarray(u).reshape(-1).view(np.int64).copy()
    return torch.from_numpy(flat).reshape(u.shape).to(resolve_device(device))


def from_int(values: Union[int, Sequence[int], np.ndarray], device=None) -> GF:
    """Build a field tensor from python ints / numpy integers (mod p)."""
    return _u64_to_tensor(_to_canonical_u64(values), device)


def from_u64(arr, device=None) -> GF:
    """Build from a numpy uint64 array (values must already be < p)."""
    return _u64_to_tensor(np.asarray(arr, dtype=np.uint64), device)


def to_u64(a: GF) -> np.ndarray:
    return a.detach().cpu().contiguous().numpy().view(np.uint64)


def to_ints(a: GF) -> np.ndarray:
    """Numpy object array of python ints."""
    return to_u64(a).astype(object)


def zeros(shape=(), device=None) -> GF:
    return torch.zeros(shape, dtype=torch.int64, device=resolve_device(device))


def ones(shape=(), device=None) -> GF:
    return torch.ones(shape, dtype=torch.int64, device=resolve_device(device))


def full(shape, value: int, device=None) -> GF:
    return from_int(value % P, device).expand(shape).contiguous()


def scalar_like(value: int, like: GF) -> GF:
    """0-d field tensor holding `value` mod p on `like`'s device."""
    return from_int(value % P, like.device)


def broadcast_to(a: GF, shape) -> GF:
    return a.expand(shape)


def concatenate(parts: Sequence[GF], axis=0) -> GF:
    return torch.cat(list(parts), dim=axis)


def stack(parts: Sequence[GF], axis=0) -> GF:
    return torch.stack(list(parts), dim=axis)


def take(a: GF, idx, axis=0) -> GF:
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx).astype(np.int64))
    idx = idx.to(device=a.device, dtype=torch.int64)
    axis = axis % a.dim()
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + tuple(idx.shape) + a.shape[axis + 1:])


# ---------------------------------------------------------------------------
# Field ops (inputs and outputs canonical). On a CUDA tensor each launches
# its hand-written kernel; on a CPU tensor it runs the plain version.
# ---------------------------------------------------------------------------

add = ck.gl_add
sub = ck.gl_sub
mul = ck.gl_mul
pow7 = ck.gl_pow7


def neg(a: GF) -> GF:
    return sub(torch.zeros((), dtype=torch.int64, device=a.device), a)


def double(a: GF) -> GF:
    return add(a, a)


def sqr(a: GF) -> GF:
    return mul(a, a)


def mul_scalar(a: GF, c: int) -> GF:
    """Multiply by a host-known constant."""
    return mul(a, scalar_like(c, a))


def pow_const(a: GF, e: int) -> GF:
    """a ** e for a host-known exponent (square and multiply)."""
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = sqr(base)
    return result


def inv(a: GF) -> GF:
    """Inverse via Fermat: a^(p-2). a == 0 maps to 0 (caller beware)."""
    return pow_const(a, P - 2)


def equal(a: GF, b: GF) -> torch.Tensor:
    return a == b


def is_zero(a: GF) -> torch.Tensor:
    return a == 0


def select(mask: torch.Tensor, a: GF, b: GF) -> GF:
    """mask ? a : b, elementwise."""
    return torch.where(mask, a, b)


# ---------------------------------------------------------------------------
# Batched linear algebra
# ---------------------------------------------------------------------------

def dot_const_matrix(m: np.ndarray, x: GF) -> GF:
    """y = m @ x for a small host-side integer matrix m (k, n), x (..., n)."""
    k, n = m.shape
    outs = []
    for i in range(k):
        acc = None
        for j in range(n):
            c = int(m[i, j]) % P
            if c == 0:
                continue
            xj = x[..., j]
            term = xj if c == 1 else mul_scalar(xj, c)
            acc = term if acc is None else add(acc, term)
        outs.append(acc if acc is not None
                    else torch.zeros_like(x[..., 0]))
    return stack(outs, axis=-1)


def sum_axis(a: GF, axis=-1) -> GF:
    """Modular sum along an axis via a log-depth tree of field adds."""
    a = torch.movedim(a, axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        s = add(a[:half], a[half:2 * half])
        if n % 2:
            s = torch.cat([s, a[n - 1:n]], dim=0)
            n = half + 1
        else:
            n = half
        a = s
    return a[0]


# ---------------------------------------------------------------------------
# Quadratic extension GF(p^2) = GF(p)[x] / (x^2 - 7)
# ---------------------------------------------------------------------------

class GF2(NamedTuple):
    """Extension element array: c0 + c1 * x with x^2 = 7."""

    c0: GF
    c1: GF

    @property
    def shape(self):
        return self.c0.shape

    @property
    def device(self):
        return self.c0.device

    def __getitem__(self, idx):
        return GF2(self.c0[idx], self.c1[idx])

    def reshape(self, *shape):
        return GF2(self.c0.reshape(*shape), self.c1.reshape(*shape))


def ext_from_base(a: GF) -> GF2:
    return GF2(a, torch.zeros_like(a))


def ext_from_ints(c0, c1, device=None) -> GF2:
    a0 = from_int(c0, device)
    return GF2(a0, from_int(c1, device).expand(a0.shape))


def ext_zeros(shape=(), device=None) -> GF2:
    return GF2(zeros(shape, device), zeros(shape, device))


def ext_ones(shape=(), device=None) -> GF2:
    return GF2(ones(shape, device), zeros(shape, device))


def ext_add(a: GF2, b: GF2) -> GF2:
    return GF2(add(a.c0, b.c0), add(a.c1, b.c1))


def ext_sub(a: GF2, b: GF2) -> GF2:
    return GF2(sub(a.c0, b.c0), sub(a.c1, b.c1))


def ext_neg(a: GF2) -> GF2:
    return GF2(neg(a.c0), neg(a.c1))


def ext_mul(a: GF2, b: GF2) -> GF2:
    # (a0 + a1 x)(b0 + b1 x) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) x
    t0 = mul(a.c0, b.c0)
    t1 = mul(a.c1, b.c1)
    c0 = add(t0, mul_scalar(t1, EXT_NONRESIDUE))
    c1 = add(mul(a.c0, b.c1), mul(a.c1, b.c0))
    return GF2(c0, c1)


def ext_mul_base(a: GF2, b: GF) -> GF2:
    return GF2(mul(a.c0, b), mul(a.c1, b))


def ext_sqr(a: GF2) -> GF2:
    return ext_mul(a, a)


def ext_inv(a: GF2) -> GF2:
    # norm = a0^2 - 7 a1^2 ; inverse = (a0 - a1 x) / norm
    norm = sub(sqr(a.c0), mul_scalar(sqr(a.c1), EXT_NONRESIDUE))
    ninv = inv(norm)
    return GF2(mul(a.c0, ninv), mul(neg(a.c1), ninv))


def ext_pow_const(a: GF2, e: int) -> GF2:
    if e == 0:
        return GF2(torch.ones_like(a.c0), torch.zeros_like(a.c1))
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e:
            base = ext_sqr(base)
    return result


def ext_equal(a: GF2, b: GF2) -> torch.Tensor:
    return equal(a.c0, b.c0) & equal(a.c1, b.c1)


def ext_select(mask, a: GF2, b: GF2) -> GF2:
    return GF2(select(mask, a.c0, b.c0), select(mask, a.c1, b.c1))


def ext_sum_axis(a: GF2, axis=-1) -> GF2:
    return GF2(sum_axis(a.c0, axis), sum_axis(a.c1, axis))


def ext_stack(parts: Sequence[GF2], axis=0) -> GF2:
    return GF2(stack([p.c0 for p in parts], axis),
               stack([p.c1 for p in parts], axis))


def ext_concat(parts: Sequence[GF2], axis=0) -> GF2:
    return GF2(concatenate([p.c0 for p in parts], axis),
               concatenate([p.c1 for p in parts], axis))


# ---------------------------------------------------------------------------
# Roots of unity and power tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def primitive_root_of_unity(log_n: int) -> int:
    """Generator of the order-2^log_n subgroup, as a python int."""
    assert 0 <= log_n <= TWO_ADICITY
    base = pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - log_n):
        base = (base * base) % P
    return base


@functools.lru_cache(maxsize=None)
def powers_host(base: int, count: int) -> np.ndarray:
    """[1, base, base^2, ...] as uint64 numpy (exact host ints)."""
    out = np.empty(count, dtype=np.uint64)
    acc = 1
    for i in range(count):
        out[i] = acc
        acc = (acc * base) % P
    return out


_HOST_TABLE_MAX = 1 << 10


def powers(base: int, count: int, mult: int = 1, device=None) -> GF:
    """[mult * base^i]_{i<count} mod p on `device`.

    Short tables come from exact host ints; long ones grow by doubling on the
    device ([t, t * base^len]), which gives the same values: field arithmetic
    is exact."""
    device = resolve_device(device)
    head = min(count, _HOST_TABLE_MAX)
    tbl = powers_host(base % P, head)
    if mult % P != 1:
        tbl = ((tbl.astype(object) * (mult % P)) % P).astype(np.uint64)
    cur = from_u64(tbl, device)
    length = head
    while length < count:
        step = scalar_like(pow(base, length, P), cur)
        cur = torch.cat([cur, mul(cur, step)])
        length *= 2
    return cur[:count]


_POWERS_CACHE: dict = {}
_POWERS_CACHE_MAX = 96


def powers_dev_cached(base: int, count: int, mult: int = 1,
                      device=None) -> GF:
    """Device-resident [mult * base^i]_{i<count} mod p, memoised per device.

    The prover's twiddle/coset/denominator tables are challenge-independent
    constants of the circuit shape; cached, a second prove skips them."""
    device = resolve_device(device)
    key = (base % P, count, mult % P, device.type, device.index)
    tbl = _POWERS_CACHE.get(key)
    if tbl is None:
        if len(_POWERS_CACHE) >= _POWERS_CACHE_MAX:
            _POWERS_CACHE.pop(next(iter(_POWERS_CACHE)))
        tbl = _POWERS_CACHE[key] = powers(base, count, mult, device)
    return tbl
