"""Code-decommitter witness (circuit type 3) + versioned bytecode hashing.

Parity with `compute_decommitter_circuit_snapshots`
(src/witness/individual_circuits/decommit_code.rs:20, SURVEY component 7):
for every unique (fresh) decommit request, check the requested versioned code
hash against the bytecode, and emit the stream of memory writes that
populated the code page, split into instances at the geometry capacity
(cycles_per_code_decommitter = 2845 words per 2^20-row instance).

Versioned hash format (zkSync Era convention): byte0 = 0x01 (version),
byte1 = 0x00, bytes2..3 = bytecode length in 32-byte words (BE),
bytes4..31 = sha256(bytecode)[4:32].

Counterpart of the JAX package's `witness/decommitter.py`; the challenges of
`compute_code_decommitter_artifacts` are drawn on the `device` it takes
(`None` means the CUDA card).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

from ..ops import goldilocks as gl
from ..vm.environment import DecommittmentQuery, MemoryLocation, MemoryQuery


def bytecode_hash(words: Sequence[int]) -> int:
    """Versioned hash of a bytecode given as 32-byte words."""
    data = b"".join(int(w).to_bytes(32, "big") for w in words)
    sha = hashlib.sha256(data).digest()
    out = bytes([0x01, 0x00]) + len(words).to_bytes(2, "big") + sha[4:32]
    return int.from_bytes(out, "big")


@dataclasses.dataclass
class CodeDecommitterCircuitArtifacts:
    """Circuit-level payloads for type 3: one in-circuit chained sha256
    per fresh bytecode (circuits/decommitter_circuit.py), digest pinned
    against the request's versioned hash."""
    instances: List  # [DecommitterInstanceInputs]
    hashes: List[int]  # versioned hash per instance, same order


def compute_code_decommitter_artifacts(
        fresh_queries: Sequence[DecommittmentQuery],
        known_bytecodes: Dict[int, Sequence[int]], device=None
        ) -> CodeDecommitterCircuitArtifacts:
    from ..circuits import decommitter_circuit as dcc
    device = gl.resolve_device(device)
    instances, hashes = [], []
    for q in fresh_queries:
        words = known_bytecodes.get(q.hash)
        if words is None:
            continue  # bootstrap/entry code outside the decommit store
        inst = dcc.instance_inputs(words, device=device)
        expected = bytecode_hash(words)
        assert expected == q.hash, "bytecode does not match versioned hash"
        instances.append(inst)
        hashes.append(q.hash)
    return CodeDecommitterCircuitArtifacts(instances=instances, hashes=hashes)


@dataclasses.dataclass
class DecommitterInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    writes: List[MemoryQuery]  # code-page population writes in this chunk
    hashes_covered: List[int]


def compute_decommitter_circuit_snapshots(
        fresh_queries: Sequence[DecommittmentQuery],
        known_bytecodes: Dict[int, Sequence[int]],
        capacity: int) -> List[DecommitterInstanceWitness]:
    """fresh_queries: deduplicated (is_fresh) decommit requests in order."""
    all_writes: List[Tuple[int, MemoryQuery]] = []
    for q in fresh_queries:
        words = known_bytecodes[q.hash]
        expected = bytecode_hash(words)
        assert expected == q.hash, (
            f"bytecode does not match its versioned hash: "
            f"{expected:#x} != {q.hash:#x}")
        assert q.decommitted_length == len(words)
        for i, w in enumerate(words):
            all_writes.append((q.hash, MemoryQuery(
                timestamp=q.timestamp,
                location=MemoryLocation(q.memory_page, i),
                value=int(w), rw_flag=True)))

    n = len(all_writes)
    n_inst = max(1, -(-n // capacity)) if n else 0
    instances = []
    for i in range(n_inst):
        chunk = all_writes[i * capacity:(i + 1) * capacity]
        instances.append(DecommitterInstanceWitness(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            writes=[w for _, w in chunk],
            hashes_covered=sorted({h for h, _ in chunk})))
    return instances
