"""KZG commitments over BLS12-381 for the EIP-4844 blob path.

Parity with the reference `kzg` crate (kzg/src/lib.rs, SURVEY L7):
  - `KzgSettings` loads the 4096-point Lagrange-form trusted setup JSON
    ({"g1_lagrange": [compressed hex]}), precomputes bit-reversed roots of
    unity (lib.rs:30-165);
  - `compute_commitment` (MSM over the Lagrange basis, lib.rs:188-217),
    `compute_proof` / `verify_kzg_proof` (single-opening quotient + pairing
    check, lib.rs:218-302).

The tau*G2 point is the public Ethereum KZG ceremony constant (the reference
embeds the same value at kzg/src/lib.rs:66-73). The setup file is read from
the path given, or from `ZKTPU_TRUSTED_SETUP`; nothing is ever fetched.
Counterpart of the JAX package's `utils/kzg.py`, moved across as it is.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

from . import bls12_381 as bls
from .bls12_381 import Q, R

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 31  # the harness packs 31 bytes per scalar

# tau*G2 from the Ethereum KZG ceremony (public constant; same value the
# reference embeds at kzg/src/lib.rs:67)
SETUP_G2_1_HEX = (
    "b5bfd7dd8cdeb128843bc287230af38926187075cbfbefa81009a2ce615ac53d"
    "2914e5870cb452d2afaaab24f3499f72185cbfee53492714734429b7b38608e2"
    "3926c911cceceac9a36851477ba4c60b087041de621000edc98edada20c1def2")

DEFAULT_SETUP_PATHS = (
    os.environ.get("ZKTPU_TRUSTED_SETUP", ""),
)


def bit_reverse_permute(values: Sequence, log_n: int) -> List:
    out = list(values)
    n = 1 << log_n
    for i in range(n):
        r = int(format(i, f"0{log_n}b")[::-1], 2)
        if r > i:
            out[i], out[r] = out[r], out[i]
    return out


class KzgSettings:
    def __init__(self, path: Optional[str] = None, domain_size: int = FIELD_ELEMENTS_PER_BLOB):
        self.domain_size = domain_size
        log_n = domain_size.bit_length() - 1
        w = bls.fr_root_of_unity(log_n)
        roots = []
        acc = 1
        for _ in range(domain_size):
            roots.append(acc)
            acc = acc * w % R
        self.roots_of_unity = roots
        self.reversed_roots = bit_reverse_permute(roots, log_n)
        self.setup_g2_1 = bls.g2_decompress(bytes.fromhex(SETUP_G2_1_HEX))
        self.g1_lagrange_brp: Optional[List] = None
        if path is None:
            for cand in DEFAULT_SETUP_PATHS:
                if cand and os.path.exists(cand):
                    path = cand
                    break
        if path:
            with open(path) as f:
                data = json.load(f)
            pts = [bls.g1_decompress(bytes.fromhex(h[2:] if h.startswith("0x")
                                                   else h))
                   for h in data["g1_lagrange"]]
            assert len(pts) == domain_size
            self.g1_lagrange_brp = bit_reverse_permute(pts, log_n)

    @classmethod
    def testing(cls, domain_size: int, tau: int = 1234567) -> "KzgSettings":
        """Small setup generated from a known tau (tests only)."""
        self = cls.__new__(cls)
        self.domain_size = domain_size
        log_n = domain_size.bit_length() - 1
        w = bls.fr_root_of_unity(log_n)
        roots = []
        acc = 1
        for _ in range(domain_size):
            roots.append(acc)
            acc = acc * w % R
        self.roots_of_unity = roots
        self.reversed_roots = bit_reverse_permute(roots, log_n)
        self.setup_g2_1 = bls.g2_mul(bls.G2_GENERATOR, tau)
        # Lagrange basis at tau: L_i(tau) * G1
        n_inv = pow(domain_size, R - 2, R)
        zh = (pow(tau, domain_size, R) - 1) % R
        lag = []
        for i in range(domain_size):
            wi = roots[i]
            # L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i))
            li = wi * zh % R * pow((tau - wi) % R, R - 2, R) % R * n_inv % R
            lag.append(bls.g1_mul(bls.G1_GENERATOR, li))
        self.g1_lagrange_brp = bit_reverse_permute(lag, log_n)
        return self


def compute_commitment(settings: KzgSettings, blob_brp: Sequence[int]):
    """Commit to evaluations given in bit-reversed order (matches reference
    layout: both setup points and blob are bit-reverse permuted)."""
    assert settings.g1_lagrange_brp is not None, "no trusted setup loaded"
    return bls.g1_msm(settings.g1_lagrange_brp, [s % R for s in blob_brp])


def compute_proof(settings: KzgSettings, blob_brp: Sequence[int], z: int
                  ) -> Tuple[int, object]:
    """Open the committed polynomial at z: returns (y = p(z), proof = [q(tau)]G1).

    q(X) = (p(X) - y)/(X - z) computed in evaluation form with the standard
    out-of-domain barycentric formula (kzg/src/lib.rs:218-260).
    """
    n = settings.domain_size
    roots = settings.reversed_roots
    z %= R
    # y = p(z) via barycentric: p(z) = (z^n - 1)/n * sum_i p_i w_i/(z - w_i)
    zh = (pow(z, n, R) - 1) % R
    y = 0
    in_domain = None
    for i in range(n):
        if (z - roots[i]) % R == 0:
            in_domain = i
            break
    if in_domain is not None:
        y = blob_brp[in_domain] % R
    else:
        s = 0
        for i in range(n):
            s = (s + blob_brp[i] * roots[i] % R *
                 pow((z - roots[i]) % R, R - 2, R)) % R
        y = s * zh % R * pow(n, R - 2, R) % R
    # quotient evaluations q_i = (p_i - y)/(w_i - z)
    q = []
    for i in range(n):
        if in_domain is not None and i == in_domain:
            # q_i = sum_{j!=i} (p_j - y) w_j / (w_i (w_i - w_j))  (special row)
            acc = 0
            wi = roots[i]
            wi_inv = pow(wi, R - 2, R)
            for j in range(n):
                if j == i:
                    continue
                acc = (acc + (blob_brp[j] - y) * roots[j] % R *
                       wi_inv % R * pow((wi - roots[j]) % R, R - 2, R)) % R
            q.append(acc)
        else:
            q.append((blob_brp[i] - y) % R *
                     pow((roots[i] - z) % R, R - 2, R) % R)
    proof = bls.g1_msm(settings.g1_lagrange_brp, q)
    return y, proof


def verify_kzg_proof(settings: KzgSettings, commitment, z: int, y: int, proof
                     ) -> bool:
    """Pairing check: e(C - y*G1, G2) == e(proof, tau*G2 - z*G2)
    (kzg/src/lib.rs:262-283)."""
    z %= R
    y %= R
    c_minus_y = bls.g1_add(commitment, bls.g1_neg(bls.g1_mul(bls.G1_GENERATOR, y)))
    x_minus_z = bls.g2_add(settings.setup_g2_1,
                           bls.g2_neg(bls.g2_mul(bls.G2_GENERATOR, z)))
    return bls.pairings_equal([(c_minus_y, bls.G2_GENERATOR)],
                              [(proof, x_minus_z)])
