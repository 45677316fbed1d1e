"""ECRecover circuit witness decomposer (circuit type 7).

Counterpart of the JAX package's `witness/ecrecover_witness.py`, as it is.
Parity with `ecrecover_decompose_into_per_circuit_witness`
(src/witness/individual_circuits/ecrecover.rs:12, SURVEY component 7): one
secp256k1 recovery per "cycle", capacity cycles_per_ecrecover_circuit = 7
recoveries per 2^20-row instance. Each invocation records the full
(hash, v, r, s) input, the recovered point, the derived address, and the
success flag (failed recoveries still occupy a cycle and return zero).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..utils import secp256k1 as ec


@dataclasses.dataclass
class EcrecoverInvocation:
    msg_hash: bytes
    v: int
    r: int
    s: int
    recovered_point: Optional[Tuple[int, int]]
    address: Optional[bytes]
    success: bool


@dataclasses.dataclass
class EcrecoverInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    invocations: List[EcrecoverInvocation]


def ecrecover_decompose(calls: Sequence[bytes], capacity: int
                        ) -> List[EcrecoverInstanceWitness]:
    """calls: 128-byte precompile inputs (hash||v||r||s, each 32 bytes)."""
    invocations = []
    for data in calls:
        assert len(data) == 128
        h = data[:32]
        v = int.from_bytes(data[32:64], "big")
        r = int.from_bytes(data[64:96], "big")
        s = int.from_bytes(data[96:128], "big")
        pt = ec.recover(h, v, r, s) if v < 2**32 else None
        addr = None
        if pt is not None:
            from ..utils.native import keccak256
            addr = keccak256(pt[0].to_bytes(32, "big")
                             + pt[1].to_bytes(32, "big"))[12:]
        invocations.append(EcrecoverInvocation(h, v, r, s, pt, addr,
                                               pt is not None))
    n = len(invocations)
    n_inst = max(1, -(-n // capacity)) if n else 0
    return [EcrecoverInstanceWitness(
        index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
        invocations=invocations[i * capacity:(i + 1) * capacity])
        for i in range(n_inst)]
