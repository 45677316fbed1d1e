"""ctypes bindings for the native batch hashers (cpp/libzkhashers.so).

Counterpart of the hash half of the JAX package's `utils/native.py`:
`keccak256`, `blake2s256` and their `_batch` forms. The shared object lies
outside both packages (under `cpp/` at the repository root) and is read in
place; it is built lazily with `make -C cpp` if it is missing, and every hash
has an exact pure-Python twin (utils/keccak.py, hashlib.blake2s), so the
hashes work without a toolchain. The MSM bindings (`bn254_msm`,
`bls12381_msm`: Pippenger over BN254 and BLS12-381 G1, `cpp/bn254_msm.cpp`)
raise where the library or its symbol is missing; the curve modules keep
their Python MSM for that case. `MSM_CALLS` counts the native MSMs that ran,
so a caller can show that the native one did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, List, Optional, Sequence

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_MSM_SYMBOLS = ("bn254_msm", "bls12381_msm")
MSM_CALLS: Dict[str, int] = {name: 0 for name in _MSM_SYMBOLS}
_CPP_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "cpp")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.abspath(os.path.join(_CPP_DIR, "libzkhashers.so"))
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", os.path.abspath(_CPP_DIR)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None  # no toolchain: the pure-Python twins serve
    try:
        lib = ctypes.CDLL(so)
        for name in ("keccak256", "blake2s256"):
            getattr(lib, name).argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
        for name in ("keccak256_batch", "blake2s256_batch"):
            getattr(lib, name).argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_char_p]
        for name in _MSM_SYMBOLS:
            if hasattr(lib, name):  # a stale .so may predate the MSM
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint64)]
                fn.restype = None
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def have_native() -> bool:
    return _load() is not None


def have_msm() -> bool:
    """True when both native MSM symbols loaded."""
    lib = _load()
    return lib is not None and all(hasattr(lib, n) for n in _MSM_SYMBOLS)


def keccak256(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        from .keccak import keccak256 as py_keccak
        return py_keccak(data)
    out = ctypes.create_string_buffer(32)
    lib.keccak256(data, len(data), out)
    return out.raw


def blake2s256(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        return hashlib.blake2s(data).digest()
    out = ctypes.create_string_buffer(32)
    lib.blake2s256(data, len(data), out)
    return out.raw


def keccak256_batch(items: Sequence[bytes]) -> List[bytes]:
    if not items:
        return []
    stride = len(items[0])
    assert all(len(b) == stride for b in items)
    lib = _load()
    if lib is None:
        from .keccak import keccak256 as py_keccak
        return [py_keccak(b) for b in items]
    blob = b"".join(items)
    out = ctypes.create_string_buffer(32 * len(items))
    lib.keccak256_batch(blob, stride, len(items), out)
    return [out.raw[32 * i:32 * (i + 1)] for i in range(len(items))]


def blake2s256_batch(items: Sequence[bytes]) -> List[bytes]:
    if not items:
        return []
    stride = len(items[0])
    assert all(len(b) == stride for b in items)
    lib = _load()
    if lib is None:
        return [hashlib.blake2s(b).digest() for b in items]
    blob = b"".join(items)
    out = ctypes.create_string_buffer(32 * len(items))
    lib.blake2s256_batch(blob, stride, len(items), out)
    return [out.raw[32 * i:32 * (i + 1)] for i in range(len(items))]


def _curve_msm(fn_name: str, points, scalars, n_limbs: int):
    """points: affine (x, y) int pairs or None (infinity); scalars: ints
    below 2^256. Returns (x, y) or None. Raises RuntimeError when the
    native library or the symbol is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, fn_name):
        raise RuntimeError(f"native {fn_name} unavailable")
    n = len(points)
    assert n == len(scalars)
    pts = (ctypes.c_uint64 * (2 * n_limbs * n))()
    scs = (ctypes.c_uint64 * (4 * n))()
    m64 = (1 << 64) - 1
    for i, (pt, sc) in enumerate(zip(points, scalars)):
        if pt is not None:
            x, y = int(pt[0]), int(pt[1])
            base = 2 * n_limbs * i
            for j in range(n_limbs):
                pts[base + j] = (x >> (64 * j)) & m64
                pts[base + n_limbs + j] = (y >> (64 * j)) & m64
        s = int(sc)
        for j in range(4):
            scs[4 * i + j] = (s >> (64 * j)) & m64
    out = (ctypes.c_uint64 * (2 * n_limbs))()
    getattr(lib, fn_name)(pts, scs, n, out)
    MSM_CALLS[fn_name] += 1
    x = sum(int(out[j]) << (64 * j) for j in range(n_limbs))
    y = sum(int(out[n_limbs + j]) << (64 * j) for j in range(n_limbs))
    if x == 0 and y == 0:
        return None
    return (x, y)


def bn254_msm(points, scalars):
    """Native Pippenger MSM over BN254 G1 (4x64 Montgomery limbs, Jacobian
    buckets): the SNARK wrapper's KZG commitments and openings."""
    return _curve_msm("bn254_msm", points, scalars, 4)


def bls12381_msm(points, scalars):
    """Native Pippenger MSM over BLS12-381 G1 (6x64 limbs): the EIP-4844
    KZG commitment (reference kzg/src/lib.rs:195-217)."""
    return _curve_msm("bls12381_msm", points, scalars, 6)
