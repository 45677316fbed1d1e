"""RAM permutation witness: sorted memory queue + grand-product argument.

Counterpart of the JAX package's `witness/ram_permutation.py`.

Parity with `compute_ram_circuit_snapshots`
(src/witness/individual_circuits/ram_permutation.rs:26-120, SURVEY component
7): sort all memory queries by (location, timestamp), re-simulate the sorted
queue's Poseidon2 chain, derive Fiat-Shamir challenges from both queue tails
(two independent repetitions, utils.rs:498 produce_fs_challenges), and build
the grand-product chains whose equality proves the sorted queue is a
permutation of the execution-order queue. Long arguments split into
fixed-capacity instances carrying the partial products as hidden FSM state
(the closed-form-input continuation of SURVEY §5).

Mapping: the hash chains are serial sponges over the Poseidon2 kernel and
the chains log-depth prefix products over the field-multiply kernel
(witness/queues.py) — replacing the reference's rayon par_sort + the chunked
sequential product pass (PARALLELIZATION_CHUNK_SIZE = 1<<16, utils.rs:552).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover.transcript import Transcript
from ..vm.environment import MemoryQuery
from .encodings import encode_memory_query, memory_sorting_key
from .queues import (FullWidthQueueSimulator, fs_challenge_terms,
                     grand_product_chain)

P = gl.P
NUM_REPETITIONS = 2  # DEFAULT_NUM_PERMUTATION_ARGUMENT_REPETITIONS
NUM_CHALLENGES = NUM_REPETITIONS * 9  # per rep: 8 encoding lanes + gamma


@dataclasses.dataclass
class RamPermutationInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    unsorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    sorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    # accumulators: (lhs_rep0, rhs_rep0, lhs_rep1, rhs_rep1)
    accumulators_in: Tuple[int, int, int, int]
    accumulators_out: Tuple[int, int, int, int]
    num_items_in: int
    num_items: int
    unsorted_encodings: np.ndarray  # (num_items, 8)
    sorted_encodings: np.ndarray    # (num_items, 8)
    prev_sorted_entry: Optional[Tuple[int, ...]]  # last sorted enc of prev


@dataclasses.dataclass
class RamPermutationArtifacts:
    instances: List[RamPermutationInstanceWitness]
    challenges: List[int]  # 18 values: [rep0 x8, gamma0, rep1 x8, gamma1]
    final_accumulators: Tuple[int, int, int, int]


def compute_ram_circuit_snapshots(memory_queries: Sequence[MemoryQuery],
                                  capacity: int,
                                  device=None) -> RamPermutationArtifacts:
    """The queue chains, the Fiat-Shamir transcript and the grand products
    run on `device` (`None` means the CUDA card); the sort by
    (location, timestamp) and the instance split are host Python."""
    unsorted_enc = np.array([encode_memory_query(q) for q in memory_queries],
                            dtype=object).reshape(-1, 8)
    order = sorted(range(len(memory_queries)),
                   key=lambda i: memory_sorting_key(memory_queries[i]))
    sorted_enc = unsorted_enc[order] if len(order) else unsorted_enc

    unsorted_q = FullWidthQueueSimulator(device=device)
    unsorted_q.push_many(unsorted_enc)
    sorted_q = FullWidthQueueSimulator(device=device)
    sorted_q.push_many(sorted_enc)

    # FS challenges bound to both queue commitments (produce_fs_challenges,
    # utils.rs:498-550 — derived from the queue tails), 2 repetitions
    tr = Transcript(domain_tag=8, device=device)  # RAM_PERMUTATION type
    tr.absorb_ints(list(unsorted_q.tail) + list(sorted_q.tail)
                   + [len(memory_queries)])
    challenges: List[int] = [tr.challenge_base() for _ in range(NUM_CHALLENGES)]

    n = len(memory_queries)
    if n == 0:
        return RamPermutationArtifacts([], challenges, (1, 1, 1, 1))

    chains = []  # lhs0, rhs0, lhs1, rhs1
    for rep in range(NUM_REPETITIONS):
        ch_gf = gl.from_int(challenges[rep * 9:rep * 9 + 8], device)
        gamma_gf = gl.from_int(challenges[rep * 9 + 8], device)
        for enc in (unsorted_enc, sorted_enc):
            terms = fs_challenge_terms(gl.from_int(enc, device), ch_gf,
                                       gamma_gf)
            chains.append([int(v) for v in
                           gl.to_u64(grand_product_chain(terms))])
    lhs0, rhs0, lhs1, rhs1 = chains[0], chains[1], chains[2], chains[3]

    u_tails = unsorted_q.tails()
    s_tails = sorted_q.tails()

    def accs(idx: int) -> Tuple[int, int, int, int]:
        if idx < 0:
            return (1, 1, 1, 1)
        return (lhs0[idx], rhs0[idx], lhs1[idx], rhs1[idx])

    instances = []
    n_inst = -(-n // capacity)
    for i in range(n_inst):
        lo = i * capacity
        hi = min(n, (i + 1) * capacity)
        instances.append(RamPermutationInstanceWitness(
            index=i,
            start_flag=(i == 0),
            completion_flag=(i == n_inst - 1),
            unsorted_queue_state=(tuple(int(v) for v in u_tails[lo]),
                                  tuple(int(v) for v in u_tails[hi]), hi - lo),
            sorted_queue_state=(tuple(int(v) for v in s_tails[lo]),
                                tuple(int(v) for v in s_tails[hi]), hi - lo),
            accumulators_in=accs(lo - 1),
            accumulators_out=accs(hi - 1),
            num_items_in=lo,
            num_items=hi - lo,
            unsorted_encodings=unsorted_enc[lo:hi],
            sorted_encodings=sorted_enc[lo:hi],
            prev_sorted_entry=(tuple(int(v) for v in sorted_enc[lo - 1])
                               if lo else None)))
    return RamPermutationArtifacts(
        instances=instances, challenges=challenges,
        final_accumulators=accs(n - 1))
