"""Sorter-family witness decomposers: events/L1-messages and storage sorters.

Counterpart of the JAX package's `witness/sorters.py`, the whole module. Every
decomposer takes `device` for its queue chains, Fiat-Shamir transcript and
grand products (`None` means the CUDA card and raises where there is none);
the sorts, dedups and instance splits are host Python as in the reference.

Parity with `compute_events_dedup_and_sort` / `compute_storage_dedup_and_sort`
(src/witness/individual_circuits/events_sort_dedup.rs:16,
storage_sort_dedup.rs:12, SURVEY component 7): each circuit proves that a
deduplicated output queue results from sorting + collapsing the demuxed input
queue, via the same two-queue grand-product permutation machinery as the RAM
sorter, split into fixed-capacity FSM instances.

Output-queue semantics:
  - events / L1 messages: rollback-cancelled pairs removed, survivors in
    chronological order;
  - storage: slot-history collapse (witness/storage_sort.py —
    sort_storage_access.rs behavior).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover.transcript import Transcript
from ..vm.environment import LogQuery
from .encodings import (encode_decommittment_request, encode_log_query,
                        encode_timestamped_log_query, event_comparison_key)
from .oracle import dedup_events
from .queues import (FullWidthQueueSimulator, QueueSimulator,
                     fs_challenge_terms, grand_product_chain)
from .storage_sort import sort_storage_access_queries

P = gl.P


@dataclasses.dataclass
class SorterInstanceWitness:
    index: int
    start_flag: bool
    completion_flag: bool
    input_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    sorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    lhs_accumulator_in: int
    lhs_accumulator_out: int
    rhs_accumulator_in: int
    rhs_accumulator_out: int


@dataclasses.dataclass
class SorterArtifacts:
    circuit_type: int
    instances: List[SorterInstanceWitness]
    output_queue: QueueSimulator  # the deduplicated result queue
    final_lhs: int
    final_rhs: int


def _permutation_argument(circuit_type: int, input_enc: np.ndarray,
                          sorted_enc: np.ndarray, capacity: int,
                          queue_cls=QueueSimulator, device=None
                          ) -> Tuple[List[SorterInstanceWitness], QueueSimulator,
                                     QueueSimulator, int, int]:
    width = input_enc.shape[1]
    in_q = queue_cls(width=width, device=device)
    in_q.push_many(input_enc)
    srt_q = queue_cls(width=sorted_enc.shape[1], device=device)
    srt_q.push_many(sorted_enc)

    tr = Transcript(domain_tag=circuit_type, device=device)
    tr.absorb_ints(list(in_q.tail) + list(srt_q.tail) + [len(input_enc)])
    challenges = gl.from_int([tr.challenge_base()
                              for _ in range(max(width, sorted_enc.shape[1]))],
                             device)
    gamma = gl.from_int(tr.challenge_base(), device)

    n = input_enc.shape[0]
    if n == 0:
        return [], in_q, srt_q, 1, 1
    lhs = [int(v) for v in gl.to_u64(grand_product_chain(
        fs_challenge_terms(gl.from_int(input_enc, device), challenges,
                           gamma)))]
    rhs = [int(v) for v in gl.to_u64(grand_product_chain(
        fs_challenge_terms(gl.from_int(sorted_enc, device), challenges,
                           gamma)))]

    in_tails = in_q.tails()
    srt_tails = srt_q.tails()
    n_inst = -(-n // capacity)
    instances = []
    for i in range(n_inst):
        lo, hi = i * capacity, min(n, (i + 1) * capacity)
        instances.append(SorterInstanceWitness(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            input_queue_state=(tuple(int(v) for v in in_tails[lo]),
                               tuple(int(v) for v in in_tails[hi]), hi - lo),
            sorted_queue_state=(tuple(int(v) for v in srt_tails[lo]),
                                tuple(int(v) for v in srt_tails[hi]), hi - lo),
            lhs_accumulator_in=lhs[lo - 1] if lo else 1,
            lhs_accumulator_out=lhs[hi - 1],
            rhs_accumulator_in=rhs[lo - 1] if lo else 1,
            rhs_accumulator_out=rhs[hi - 1]))
    return instances, in_q, srt_q, lhs[-1], rhs[-1]


def compute_events_dedup_and_sort(queries: Sequence[LogQuery], capacity: int,
                                  circuit_type: int = 11,
                                  device=None) -> SorterArtifacts:
    """Events (or L1 messages with circuit_type=12) sorter circuit witness.
    Sorted by the event comparison key (timestamp — log_query.rs:94-98),
    rollbacks ordered after their forwards."""
    W = 20
    input_enc = np.array([encode_log_query(q) for q in queries],
                         dtype=object).reshape(-1, W)
    sorted_qs = sorted(queries, key=lambda q: (event_comparison_key(q),
                                               q.rollback))
    sorted_enc = np.array([encode_log_query(q) for q in sorted_qs],
                          dtype=object).reshape(-1, W)
    instances, in_q, srt_q, lhs, rhs = _permutation_argument(
        circuit_type, input_enc, sorted_enc, capacity, device=device)
    out_q = QueueSimulator(device=device)
    out_q.push_many([encode_log_query(q) for q in dedup_events(list(queries))])
    return SorterArtifacts(circuit_type, instances, out_q, lhs, rhs)


def compute_storage_dedup_and_sort(queries: Sequence[LogQuery], capacity: int,
                                   device=None) -> SorterArtifacts:
    """Storage sorter circuit witness (circuit type 9). Both sides of the
    permutation argument carry the extended enumeration timestamp
    (TimestampedStorageLogRecord — log_query.rs:400-427), so the sorted
    queue's encodings are a true permutation of the input queue's."""
    W = 20
    input_enc = np.array(
        [encode_timestamped_log_query(q, i) for i, q in enumerate(queries)],
        dtype=object).reshape(-1, W)
    with_ts, dedup = sort_storage_access_queries(list(queries))
    sorted_enc = np.array(
        [encode_timestamped_log_query(e.raw_query, e.extended_timestamp)
         for e in with_ts], dtype=object).reshape(-1, W)
    instances, in_q, srt_q, lhs, rhs = _permutation_argument(
        9, input_enc, sorted_enc, capacity, device=device)
    out_q = QueueSimulator(device=device)
    out_q.push_many([encode_log_query(q) for q in dedup])
    return SorterArtifacts(9, instances, out_q, lhs, rhs)


# --------------------------------------------------------------------------
# Full per-instance circuit witness for the events/L1-messages sorter
# (the decomposer->columns payload consumed by
# circuits/events_sorter_circuit.py; events_sort_dedup.rs:16 behavior)
# --------------------------------------------------------------------------

EVENTS_NUM_REPETITIONS = 2
EVENTS_ENC_W = 20
EVENTS_NUM_CHALLENGES = EVENTS_NUM_REPETITIONS * (EVENTS_ENC_W + 1)  # 42


@dataclasses.dataclass
class EventsCircuitInstance:
    index: int
    start_flag: bool
    completion_flag: bool
    input_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    sorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    output_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    accumulators_in: Tuple[int, int, int, int]
    accumulators_out: Tuple[int, int, int, int]
    num_items_in: int
    num_items: int
    out_items_in: int
    out_items: int
    input_encodings: np.ndarray   # (num_items, 20)
    sorted_encodings: np.ndarray  # (num_items, 20)
    prev_ts: int


@dataclasses.dataclass
class EventsCircuitArtifacts:
    circuit_type: int
    instances: List[EventsCircuitInstance]
    challenges: List[int]          # 42
    output_queue: QueueSimulator   # deduplicated result queue
    final_accumulators: Tuple[int, int, int, int]


def _event_ts(enc: Sequence[int]) -> int:
    return int(enc[16]) & 0xFFFFFFFF


def compute_events_circuit_artifacts(queries: Sequence[LogQuery],
                                     capacity: int,
                                     circuit_type: int = 11,
                                     device=None) -> EventsCircuitArtifacts:
    """Full circuit-instance payloads for the events (11) / L1-messages (12)
    sorter: 2-repetition permutation argument, per-instance queue segments
    for all three queues, and SAFE-SPLIT boundaries (an instance never starts
    with the rollback half of a cancellation pair — the circuit enforces this
    via its first-row constraint)."""
    n = len(queries)
    input_enc = np.array([encode_log_query(q) for q in queries],
                         dtype=object).reshape(-1, EVENTS_ENC_W)
    sorted_qs = sorted(queries, key=lambda q: (event_comparison_key(q),
                                               q.rollback))
    sorted_enc = np.array([encode_log_query(q) for q in sorted_qs],
                          dtype=object).reshape(-1, EVENTS_ENC_W)

    in_q = QueueSimulator(device=device)
    in_q.push_many(input_enc)
    srt_q = QueueSimulator(device=device)
    srt_q.push_many(sorted_enc)

    tr = Transcript(domain_tag=circuit_type, device=device)
    tr.absorb_ints(list(in_q.tail) + list(srt_q.tail) + [n])
    challenges = [tr.challenge_base() for _ in range(EVENTS_NUM_CHALLENGES)]

    # emission flags over the sorted stream (dedup_events semantics)
    ts_seq = [_event_ts(e) for e in sorted_enc]
    rb_seq = [int(e[19]) & 1 for e in sorted_enc]
    emit = [0] * n
    for j in range(n):
        cancelled = (j + 1 < n and ts_seq[j + 1] == ts_seq[j])
        emit[j] = 1 if (rb_seq[j] == 0 and not cancelled) else 0
    out_q = QueueSimulator(device=device)
    out_q.push_many([sorted_enc[j] for j in range(n) if emit[j]])

    # grand-product chains (2 repetitions)
    chains = []
    if n:
        for rep in range(EVENTS_NUM_REPETITIONS):
            base = rep * (EVENTS_ENC_W + 1)
            ch_gf = gl.from_int(challenges[base:base + EVENTS_ENC_W], device)
            gm = gl.from_int(challenges[base + EVENTS_ENC_W], device)
            for enc in (input_enc, sorted_enc):
                terms = fs_challenge_terms(gl.from_int(enc, device), ch_gf,
                                           gm)
                chains.append([int(v) for v in
                               gl.to_u64(grand_product_chain(terms))])

    def accs(idx: int) -> Tuple[int, int, int, int]:
        if idx < 0 or not chains:
            return (1, 1, 1, 1)
        return (chains[0][idx], chains[1][idx], chains[2][idx], chains[3][idx])

    # safe-split boundaries
    bounds = [0]
    while bounds[-1] < n:
        b = min(bounds[-1] + capacity, n)
        if b < n and ts_seq[b] == ts_seq[b - 1]:
            b -= 1
        assert b > bounds[-1], "capacity too small to safe-split"
        bounds.append(b)
    if n == 0:
        bounds = [0, 0]

    in_tails = in_q.tails()
    srt_tails = srt_q.tails()
    out_tails = out_q.tails()
    emit_prefix = np.concatenate([[0], np.cumsum(emit)]) if n else [0, 0]

    instances = []
    n_inst = len(bounds) - 1
    for i in range(n_inst):
        lo, hi = bounds[i], bounds[i + 1]
        olo, ohi = int(emit_prefix[lo]), int(emit_prefix[hi])
        instances.append(EventsCircuitInstance(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            input_queue_state=(tuple(int(v) for v in in_tails[lo]),
                               tuple(int(v) for v in in_tails[hi]), hi - lo),
            sorted_queue_state=(tuple(int(v) for v in srt_tails[lo]),
                                tuple(int(v) for v in srt_tails[hi]), hi - lo),
            output_queue_state=(tuple(int(v) for v in out_tails[olo]),
                                tuple(int(v) for v in out_tails[ohi]),
                                ohi - olo),
            accumulators_in=accs(lo - 1), accumulators_out=accs(hi - 1),
            num_items_in=lo, num_items=hi - lo,
            out_items_in=olo, out_items=ohi - olo,
            input_encodings=input_enc[lo:hi],
            sorted_encodings=sorted_enc[lo:hi],
            prev_ts=ts_seq[lo - 1] if lo else 0))
    return EventsCircuitArtifacts(
        circuit_type=circuit_type, instances=instances, challenges=challenges,
        output_queue=out_q, final_accumulators=accs(n - 1))


# --------------------------------------------------------------------------
# Storage sorter (circuit type 9): full per-instance circuit payloads
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StorageCircuitInstance:
    index: int
    start_flag: bool
    completion_flag: bool
    input_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    sorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    output_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    accumulators_in: Tuple[int, int, int, int]
    accumulators_out: Tuple[int, int, int, int]
    num_items_in: int
    num_items: int
    out_items_in: int
    out_items: int
    input_encodings: np.ndarray   # (num_items, 20)
    sorted_encodings: np.ndarray  # (num_items, 20)
    prev_enc: "np.ndarray | None"  # previous sorted encoding or None


@dataclasses.dataclass
class StorageCircuitArtifacts:
    circuit_type: int
    instances: List[StorageCircuitInstance]
    challenges: List[int]          # 42
    output_queue: QueueSimulator   # net storage accesses (dedup result)
    final_accumulators: Tuple[int, int, int, int]


def compute_storage_circuit_artifacts(queries: Sequence[LogQuery],
                                      capacity: int, device=None
                                      ) -> StorageCircuitArtifacts:
    """Full circuit-instance payloads for the storage sorter (type 9):
    2-repetition permutation argument over the TIMESTAMPED encodings,
    per-instance queue segments for input/sorted/output, and SAFE-SPLIT
    boundaries at storage-cell boundaries (the circuit's first-row
    constraint forbids an instance starting inside a cell). The emitted
    output stream is cross-checked against the behavioral
    sort_storage_access_queries dedup (sort_storage_access.rs:19-260)."""
    n = len(queries)
    W = EVENTS_ENC_W
    input_enc = np.array(
        [encode_timestamped_log_query(q, i) for i, q in enumerate(queries)],
        dtype=object).reshape(-1, W)
    with_ts, dedup = sort_storage_access_queries(list(queries))
    sorted_enc = np.array(
        [encode_timestamped_log_query(e.raw_query, e.extended_timestamp)
         for e in with_ts], dtype=object).reshape(-1, W)

    in_q = QueueSimulator(device=device)
    in_q.push_many(input_enc)
    srt_q = QueueSimulator(device=device)
    srt_q.push_many(sorted_enc)

    tr = Transcript(domain_tag=9, device=device)
    tr.absorb_ints(list(in_q.tail) + list(srt_q.tail) + [n])
    challenges = [tr.challenge_base() for _ in range(EVENTS_NUM_CHALLENGES)]

    # cell boundaries + per-element emission (the in-circuit replay's view)
    def cell_of(e):
        q = e.raw_query
        return (q.shard_id, q.address, q.key)

    emit = [0] * n
    out_encs: List[List[int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and cell_of(with_ts[j]) == cell_of(with_ts[i]):
            j += 1
        group = [e.raw_query for e in with_ts[i:j]]
        initial = group[0].read_value
        current = initial
        depth = 0
        rdz = 0
        for q in group:
            if q.rw_flag:
                if q.rollback:
                    depth -= 1
                    current = q.read_value
                else:
                    depth += 1
                    current = q.written_value
            elif depth == 0:
                rdz = 1
        if initial != current or rdz:
            emit[j - 1] = 1
            cand = group[0]
            out_encs.append(encode_log_query(LogQuery(
                timestamp=0, tx_number_in_block=0, aux_byte=cand.aux_byte,
                shard_id=cand.shard_id, address=cand.address, key=cand.key,
                read_value=initial, written_value=current,
                rw_flag=(initial != current))))
        i = j
    out_q = QueueSimulator(device=device)
    out_q.push_many(out_encs)
    # behavioral cross-check against the reference dedup function
    ref_encs = [encode_log_query(q) for q in dedup]
    assert out_encs == ref_encs, \
        "in-circuit emission diverged from sort_storage_access semantics"

    chains = []
    if n:
        for rep in range(EVENTS_NUM_REPETITIONS):
            base = rep * (W + 1)
            ch_gf = gl.from_int(challenges[base:base + W], device)
            gm = gl.from_int(challenges[base + W], device)
            for enc in (input_enc, sorted_enc):
                terms = fs_challenge_terms(gl.from_int(enc, device), ch_gf,
                                           gm)
                chains.append([int(v) for v in
                               gl.to_u64(grand_product_chain(terms))])

    def accs(idx: int) -> Tuple[int, int, int, int]:
        if idx < 0 or not chains:
            return (1, 1, 1, 1)
        return (chains[0][idx], chains[1][idx], chains[2][idx],
                chains[3][idx])

    # safe-split: never split inside a cell
    bounds = [0]
    while bounds[-1] < n:
        b = min(bounds[-1] + capacity, n)
        while b < n and cell_of(with_ts[b]) == cell_of(with_ts[b - 1]):
            b -= 1
        assert b > bounds[-1], "capacity smaller than a storage-cell group"
        bounds.append(b)
    if n == 0:
        bounds = [0, 0]

    in_tails = in_q.tails()
    srt_tails = srt_q.tails()
    out_tails = out_q.tails()
    emit_prefix = np.concatenate([[0], np.cumsum(emit)]) if n else [0, 0]

    instances = []
    n_inst = len(bounds) - 1
    for i in range(n_inst):
        lo, hi = bounds[i], bounds[i + 1]
        olo, ohi = int(emit_prefix[lo]), int(emit_prefix[hi])
        instances.append(StorageCircuitInstance(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            input_queue_state=(tuple(int(v) for v in in_tails[lo]),
                               tuple(int(v) for v in in_tails[hi]), hi - lo),
            sorted_queue_state=(tuple(int(v) for v in srt_tails[lo]),
                                tuple(int(v) for v in srt_tails[hi]),
                                hi - lo),
            output_queue_state=(tuple(int(v) for v in out_tails[olo]),
                                tuple(int(v) for v in out_tails[ohi]),
                                ohi - olo),
            accumulators_in=accs(lo - 1), accumulators_out=accs(hi - 1),
            num_items_in=lo, num_items=hi - lo,
            out_items_in=olo, out_items=ohi - olo,
            input_encodings=input_enc[lo:hi],
            sorted_encodings=sorted_enc[lo:hi],
            prev_enc=(sorted_enc[lo - 1] if lo else None)))
    return StorageCircuitArtifacts(
        circuit_type=9, instances=instances, challenges=challenges,
        output_queue=out_q, final_accumulators=accs(n - 1))


# --------------------------------------------------------------------------
# Decommittment requests sorter (circuit type 2) + decommitter feed (type 3)
# --------------------------------------------------------------------------

DECOMMITTS_NUM_CHALLENGES = 18  # 2 repetitions x (8 per-lane + gamma)


@dataclasses.dataclass
class DecommittsCircuitInstance:
    index: int
    start_flag: bool
    completion_flag: bool
    unsorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    sorted_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    output_queue_state: Tuple[Tuple[int, ...], Tuple[int, ...], int]
    accumulators_in: Tuple[int, int, int, int]
    accumulators_out: Tuple[int, int, int, int]
    num_items_in: int
    num_items: int
    out_items_in: int
    out_items: int
    unsorted_encodings: np.ndarray  # (num_items, 8)
    sorted_encodings: np.ndarray    # (num_items, 8)
    prev_sorted_entry: "np.ndarray | None"  # 8-limb enc or None


@dataclasses.dataclass
class DecommittsCircuitArtifacts:
    circuit_type: int
    instances: List[DecommittsCircuitInstance]
    challenges: List[int]                  # 18
    output_queue: FullWidthQueueSimulator  # fresh requests (decommitter feed)
    final_accumulators: Tuple[int, int, int, int]


def compute_decommitts_circuit_artifacts(queries, capacity: int, device=None
                                         ) -> DecommittsCircuitArtifacts:
    """Full circuit-instance payloads for the code-decommittments sorter
    (type 2): 2-repetition permutation argument over the full-width request
    queues, per-instance segments for unsorted/sorted/output queues, and the
    previous sorted entry as cross-instance comparison context
    (sort_decommit_requests.rs behavior; consumed by
    circuits/decommitts_sorter_circuit.py)."""
    n = len(queries)
    W = 8
    input_enc = np.array([encode_decommittment_request(q) for q in queries],
                         dtype=object).reshape(-1, W)
    sorted_qs = sorted(queries, key=lambda q: (q.hash, q.timestamp))
    sorted_enc = np.array([encode_decommittment_request(q) for q in sorted_qs],
                          dtype=object).reshape(-1, W)

    in_q = FullWidthQueueSimulator(device=device)
    in_q.push_many(input_enc)
    srt_q = FullWidthQueueSimulator(device=device)
    srt_q.push_many(sorted_enc)

    tr = Transcript(domain_tag=2, device=device)
    tr.absorb_ints(list(in_q.tail) + list(srt_q.tail) + [n])
    challenges = [tr.challenge_base()
                  for _ in range(DECOMMITTS_NUM_CHALLENGES)]

    # emission flags: fresh requests (first per hash in sorted order)
    emit = []
    prev_hash = None
    for q in sorted_qs:
        emit.append(1 if q.hash != prev_hash else 0)
        prev_hash = q.hash
    out_q = FullWidthQueueSimulator(device=device)
    out_q.push_many([sorted_enc[j] for j in range(n) if emit[j]])

    chains = []
    if n:
        for rep in range(2):
            base = rep * 9
            ch_gf = gl.from_int(challenges[base:base + W], device)
            gm = gl.from_int(challenges[base + W], device)
            for enc in (input_enc, sorted_enc):
                terms = fs_challenge_terms(gl.from_int(enc, device), ch_gf,
                                           gm)
                chains.append([int(v) for v in
                               gl.to_u64(grand_product_chain(terms))])

    def accs(idx: int) -> Tuple[int, int, int, int]:
        if idx < 0 or not chains:
            return (1, 1, 1, 1)
        return (chains[0][idx], chains[1][idx], chains[2][idx],
                chains[3][idx])

    in_tails = in_q.tails()
    srt_tails = srt_q.tails()
    out_tails = out_q.tails()
    emit_prefix = np.concatenate([[0], np.cumsum(emit)]) if n else [0, 0]

    # always at least one instance: an empty block still produces an (empty)
    # sorter circuit, like the reference's per-type minimum
    n_inst = max(1, -(-n // capacity))
    instances = []
    for i in range(n_inst):
        lo, hi = i * capacity, min(n, (i + 1) * capacity)
        olo, ohi = int(emit_prefix[lo]), int(emit_prefix[hi])
        instances.append(DecommittsCircuitInstance(
            index=i, start_flag=(i == 0), completion_flag=(i == n_inst - 1),
            unsorted_queue_state=(tuple(int(v) for v in in_tails[lo]),
                                  tuple(int(v) for v in in_tails[hi]),
                                  hi - lo),
            sorted_queue_state=(tuple(int(v) for v in srt_tails[lo]),
                                tuple(int(v) for v in srt_tails[hi]),
                                hi - lo),
            output_queue_state=(tuple(int(v) for v in out_tails[olo]),
                                tuple(int(v) for v in out_tails[ohi]),
                                ohi - olo),
            accumulators_in=accs(lo - 1), accumulators_out=accs(hi - 1),
            num_items_in=lo, num_items=hi - lo,
            out_items_in=olo, out_items=ohi - olo,
            unsorted_encodings=input_enc[lo:hi],
            sorted_encodings=sorted_enc[lo:hi],
            prev_sorted_entry=(sorted_enc[lo - 1] if lo else None)))
    return DecommittsCircuitArtifacts(
        circuit_type=2, instances=instances, challenges=challenges,
        output_queue=out_q, final_accumulators=accs(n - 1))


def compute_decommitts_sorter(queries, capacity: int,
                              device=None) -> SorterArtifacts:
    """Sort decommit requests by (hash, timestamp); the deduplicated output
    queue keeps only the first (fresh) request per code hash — the feed for
    the code-decommitter circuit (sort_decommit_requests.rs:20,
    decommit_code.rs:20). Decommit queues are full-width (12-element states,
    decommittment_request.rs:76-84)."""
    input_enc = np.array([encode_decommittment_request(q) for q in queries],
                         dtype=object).reshape(-1, 8)
    sorted_qs = sorted(queries, key=lambda q: (q.hash, q.timestamp))
    sorted_enc = np.array([encode_decommittment_request(q) for q in sorted_qs],
                          dtype=object).reshape(-1, 8)
    instances, in_q, srt_q, lhs, rhs = _permutation_argument(
        2, input_enc, sorted_enc, capacity, queue_cls=FullWidthQueueSimulator,
        device=device)
    seen = set()
    unique = []
    for q in sorted_qs:
        if q.hash not in seen:
            seen.add(q.hash)
            unique.append(q)
    out_q = FullWidthQueueSimulator(device=device)
    out_q.push_many([encode_decommittment_request(q) for q in unique])
    return SorterArtifacts(2, instances, out_q, lhs, rhs)
