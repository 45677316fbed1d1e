"""Precompile round-function witness decomposers (keccak256 / sha256).

Parity with `keccak256_decompose_into_per_circuit_witness` /
`sha256_...` (src/witness/individual_circuits/keccak256_round_function.rs:23,
sha256_round_function.rs:23, SURVEY component 7): replay each precompile
call's sponge/compression schedule, recording one round-function invocation
witness per permutation/compression (the unit the round-function circuits
prove: geometry capacities 293 keccak-f / 2206 sha256-compress per 2^20-row
instance), then split into fixed-capacity FSM instances.

Counterpart of the JAX package's `witness/precompile_rounds.py`: exact host
Python, moved across unchanged.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

from ..utils.keccak import keccak_f

KECCAK_RATE = 136


@dataclasses.dataclass
class RoundFunctionInvocation:
    call_index: int
    round_index: int  # permutation index within the call
    state_in: Tuple[int, ...]  # 25 u64 lanes (keccak) / 8 u32 words (sha256)
    block: bytes  # absorbed block for this permutation
    state_out: Tuple[int, ...]


@dataclasses.dataclass
class RoundFunctionInstances:
    invocations: List[RoundFunctionInvocation]
    instances: List[List[RoundFunctionInvocation]]  # capacity-sized chunks
    digests: List[bytes]


def _keccak_rounds_for_call(call_index: int, data: bytes
                            ) -> Tuple[List[RoundFunctionInvocation], bytes]:
    state = [[0] * 5 for _ in range(5)]
    padded = bytearray(data)
    pad_len = KECCAK_RATE - (len(padded) % KECCAK_RATE)
    if pad_len >= 2:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    else:
        padded += b"\x81"
    invocations = []
    for r, ofs in enumerate(range(0, len(padded), KECCAK_RATE)):
        block = bytes(padded[ofs:ofs + KECCAK_RATE])
        flat_in = tuple(state[i % 5][i // 5] for i in range(25))
        for i in range(KECCAK_RATE // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            state[i % 5][i // 5] ^= lane
        state = keccak_f(state)
        flat_out = tuple(state[i % 5][i // 5] for i in range(25))
        invocations.append(RoundFunctionInvocation(call_index, r, flat_in,
                                                   block, flat_out))
    digest = b"".join(state[i % 5][i // 5].to_bytes(8, "little")
                      for i in range(4))
    return invocations, digest


def keccak256_decompose(calls: Sequence[bytes], capacity: int
                        ) -> RoundFunctionInstances:
    """calls: raw input bytes per precompile call; capacity: keccak-f per
    circuit instance (geometry cycles_per_keccak256_circuit)."""
    invocations: List[RoundFunctionInvocation] = []
    digests: List[bytes] = []
    for ci, data in enumerate(calls):
        invs, digest = _keccak_rounds_for_call(ci, data)
        invocations.extend(invs)
        digests.append(digest)
    instances = [invocations[i:i + capacity]
                 for i in range(0, len(invocations), capacity)] or []
    return RoundFunctionInstances(invocations, instances, digests)


# --------------------------------------------------------------------------
# sha256 (FIPS 180-4 compression schedule)
# --------------------------------------------------------------------------

_SHA_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
_M32 = 0xFFFFFFFF


def _rotr(x, s):
    return ((x >> s) | (x << (32 - s))) & _M32


def _sha256_compress(h: List[int], block: bytes) -> List[int]:
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, hh = h
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (hh + s1 + ch + _SHA_K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        hh, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, \
            (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(h, [a, b, c, d, e, f, g, hh])]


def sha256_decompose(calls: Sequence[bytes], capacity: int
                     ) -> RoundFunctionInstances:
    iv = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]
    invocations: List[RoundFunctionInvocation] = []
    digests: List[bytes] = []
    for ci, data in enumerate(calls):
        bitlen = len(data) * 8
        padded = bytearray(data) + b"\x80"
        while len(padded) % 64 != 56:
            padded += b"\x00"
        padded += bitlen.to_bytes(8, "big")
        h = list(iv)
        for r, ofs in enumerate(range(0, len(padded), 64)):
            block = bytes(padded[ofs:ofs + 64])
            h_in = tuple(h)
            h = _sha256_compress(h, block)
            invocations.append(RoundFunctionInvocation(ci, r, h_in, block,
                                                       tuple(h)))
        digests.append(b"".join(x.to_bytes(4, "big") for x in h))
    instances = [invocations[i:i + capacity]
                 for i in range(0, len(invocations), capacity)] or []
    return RoundFunctionInstances(invocations, instances, digests)
