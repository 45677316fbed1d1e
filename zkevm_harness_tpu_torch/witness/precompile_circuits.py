"""Per-instance circuit payloads for the precompile round-function circuits
(keccak type 5 / sha256 type 6).

Parity with the reference's per-circuit witness splitting
(src/witness/individual_circuits/{keccak256,sha256}_round_function.rs:23):
decompose every traced precompile call into round-function invocations
(witness/precompile_rounds.py), draw the binding challenges AFTER committing
the full invocation stream (challenge-after-commit, the same discipline as
the sorters' permutation arguments), then split into fixed-capacity
instances whose fingerprint accumulators and invocation counts chain across
the FSM boundary — acc_out/cnt_out of instance k are acc_in/cnt_in of
instance k+1, and the final accumulators are the block-level binding value
the scheduler witness pins.

Counterpart of the JAX package's `witness/precompile_circuits.py`; the
challenges' hash and transcript run on the `device` each entry point takes
(`None` means the CUDA card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .precompile_rounds import (RoundFunctionInvocation, keccak256_decompose,
                                sha256_decompose)


@dataclasses.dataclass
class RoundFunctionInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    invocations: List[RoundFunctionInvocation]
    acc_in: Tuple[int, int]
    acc_out: Tuple[int, int]
    cnt_in: int
    cnt_out: int


@dataclasses.dataclass
class RoundFunctionCircuitArtifacts:
    circuit_type: int
    instances: List[RoundFunctionInstanceWitness]
    challenges: Tuple[int, int]
    gammas: Tuple[int, int]
    final_accs: Tuple[int, int]
    total_invocations: int
    digests: List[bytes]


def _chain_instances(circuit_type: int, chunks, challenges, gammas,
                     fingerprint_fn, digests) -> RoundFunctionCircuitArtifacts:
    instances: List[RoundFunctionInstanceWitness] = []
    accs = (1, 1)
    cnt = 0
    total = sum(len(c) for c in chunks)
    for i, chunk in enumerate(chunks):
        acc_out = tuple(fingerprint_fn(challenges, gammas, chunk, accs))
        instances.append(RoundFunctionInstanceWitness(
            index=i, start_flag=(i == 0),
            completion_flag=(i == len(chunks) - 1),
            invocations=list(chunk), acc_in=accs, acc_out=acc_out,
            cnt_in=cnt, cnt_out=cnt + len(chunk)))
        accs = acc_out
        cnt += len(chunk)
    return RoundFunctionCircuitArtifacts(
        circuit_type=circuit_type, instances=instances,
        challenges=tuple(challenges), gammas=tuple(gammas),
        final_accs=tuple(accs), total_invocations=total,
        digests=list(digests))


def compute_keccak_circuit_artifacts(calls: Sequence[bytes], capacity: int,
                                     device=None
                                     ) -> RoundFunctionCircuitArtifacts:
    """calls: raw input bytes of each traced keccak precompile call;
    capacity: keccak-f invocations per instance."""
    from ..circuits import keccak_circuit as kc
    dec = keccak256_decompose(calls, capacity)
    ch, gm = kc.draw_keccak_challenges(dec.invocations, device=device)

    def fp(challenges, gammas, chunk, acc_in):
        inst = kc.instance_inputs(chunk, challenges, gammas, acc_in)
        return kc.fingerprint(challenges, gammas, inst.state_pairs, acc_in)

    chunks = dec.instances or [[]]
    return _chain_instances(5, chunks, ch, gm, fp, dec.digests)


def compute_sha256_circuit_artifacts(calls: Sequence[bytes], capacity: int,
                                     device=None
                                     ) -> RoundFunctionCircuitArtifacts:
    """calls: raw input bytes of each traced sha256 precompile call;
    capacity: compressions per instance."""
    from ..circuits import sha256_circuit as sc
    dec = sha256_decompose(calls, capacity)
    ch, gm = sc.draw_sha256_challenges(dec.invocations, device=device)

    def fp(challenges, gammas, chunk, acc_in):
        inst = sc.instance_inputs(chunk, challenges, gammas, acc_in)
        return sc.fingerprint(challenges, gammas, inst.triples, acc_in)

    chunks = dec.instances or [[]]
    return _chain_instances(6, chunks, ch, gm, fp, dec.digests)
