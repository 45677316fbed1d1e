"""EIP-4844 blob witness generation (blob -> KZG commitment -> hash chain).

Behavioral parity with the reference `generate_eip4844_witness`
(src/utils.rs:123-231):
  blob (31*N bytes) -> monomial poly (31-byte LE chunks as Fr) -> FFT ->
  bit-reverse -> KZG commitment over the Lagrange setup -> versioned hash
  (sha256 of compressed commitment, byte0 = 1) -> linear hash (keccak256 of
  blob) -> Fiat-Shamir evaluation point (low 16 bytes of
  keccak256(linear_hash || versioned_hash)) -> Horner opening fold (chunk 0 is
  the HIGHEST-degree coefficient) -> output hash
  keccak256(versioned_hash || eval_point_16 || opening_value_be32).

Counterpart of the JAX package's `witness/eip4844.py`, moved across as it is.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from ..utils import bls12_381 as bls
from ..utils import kzg as kzg_mod
from ..utils.bls12_381 import R
from ..utils.native import keccak256

BYTES_PER_CHUNK = 31


def pubdata_to_monomial_poly(blob: bytes, n: int) -> List[int]:
    assert len(blob) == BYTES_PER_CHUNK * n
    return [int.from_bytes(blob[i * 31:(i + 1) * 31], "little") % R
            for i in range(n)]


def fr_fft(poly: Sequence[int]) -> List[int]:
    """Monomial -> evaluations on the order-n Fr subgroup (natural order)."""
    n = len(poly)
    log_n = n.bit_length() - 1
    w = bls.fr_root_of_unity(log_n)
    # bit-reversed-input iterative Cooley-Tukey
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


def generate_eip4844_witness(blob: bytes, settings: kzg_mod.KzgSettings
                             ) -> Tuple[List[bytes], bytes, bytes, bytes]:
    """Returns (blob chunks, linear_hash, versioned_hash, output_hash)."""
    n = settings.domain_size
    assert len(blob) == BYTES_PER_CHUNK * n
    chunks = [blob[i * 31:(i + 1) * 31] for i in range(n)]

    poly = pubdata_to_monomial_poly(blob, n)
    evals = fr_fft(poly)
    evals_brp = kzg_mod.bit_reverse_permute(evals, n.bit_length() - 1)
    commitment = kzg_mod.compute_commitment(settings, evals_brp)

    versioned_hash = bytearray(hashlib.sha256(bls.g1_compress(commitment)).digest())
    versioned_hash[0] = 1
    versioned_hash = bytes(versioned_hash)

    linear_hash = keccak256(blob)

    evaluation_point = keccak256(linear_hash + versioned_hash)[16:]
    x = int.from_bytes(evaluation_point, "big") % R

    # Horner fold: chunk 0 is the highest-degree coefficient
    acc = 0
    for i, chunk in enumerate(chunks):
        el = int.from_bytes(chunk, "little") % R
        acc = (acc + el) % R
        if i != n - 1:
            acc = acc * x % R
    opening_value = acc

    output_hash = keccak256(versioned_hash + evaluation_point +
                            opening_value.to_bytes(32, "big"))
    return chunks, linear_hash, versioned_hash, output_hash
