"""Witness oracle: tracer -> per-circuit artifacts (queues, dedups, instances).

Counterpart of the JAX package's `witness/oracle.py`, the round-1 slice of
the reference's `create_artifacts_from_tracer` (src/witness/oracle.rs:185):
  - flatten the rollback-resolved log queue through a Poseidon2 queue
    simulator (the chain of states the demux circuit consumes);
  - demux into the query classes (storage / events / L1 messages / keccak /
    sha256 / ecrecover precompiles) — log_demux.rs:20;
  - simulate the memory queue, and its copy sorted by (location, timestamp)
    for the RAM permutation argument — ram_permutation.rs:26-120;
  - storage dedup via the slot-history sorter; events / L1 dedup by
    rollback cancellation — storage_sort_dedup.rs / events_sort_dedup.rs;
  - run every base circuit type's decomposer, split each argument into
    fixed-capacity instances per the geometry, and build the per-type
    recursion queues consumed by the aggregation DAG.

`device` is where the decomposers' queue chains, challenge hashes and grand
products run (`None`: the CUDA card, raising where there is none). Each
decomposer runs inside an `oracle.<name>` span of utils/tracing.py, the
artifacts time of a traced run.

`block_payloads` turns the artifacts into the per-type instance payloads
(instances, binding challenges, capacity) that the typed prover surface
(`prover/layers.py`) proves, as the JAX package's `harness.py` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..circuits.types import (BaseLayerCircuitType, GeometryConfig,
                              base_capacity)
from ..ops import goldilocks as gl
from ..utils import tracing
from ..vm.environment import (AUX_BYTE_EVENT, AUX_BYTE_L1_MESSAGE,
                              AUX_BYTE_PRECOMPILE, AUX_BYTE_STORAGE,
                              DefaultPrecompilesProcessor, LogQuery)
from .encodings import (encode_log_query, encode_memory_query,
                        memory_sorting_key)
from .queues import FullWidthQueueSimulator, QueueSimulator
from .recursion import RecursionQueueSimulator, RecursionRequest
from .tracer import WitnessTracer

P = 0xFFFFFFFF_00000001


@dataclasses.dataclass
class PerCircuitArtifacts:
    queue: QueueSimulator
    num_instances: int
    capacity: int


@dataclasses.dataclass
class BlockArtifacts:
    log_queue: QueueSimulator  # full rollback-resolved log queue (narrow, 20)
    demuxed: Dict[str, List[Tuple[int, LogQuery]]]
    memory_queue: FullWidthQueueSimulator
    sorted_memory_queue: FullWidthQueueSimulator
    deduplicated_storage: List[LogQuery]
    deduplicated_events: List[LogQuery]
    deduplicated_l1_messages: List[LogQuery]
    per_circuit: Dict[int, PerCircuitArtifacts]
    recursion_queues: Dict[int, RecursionQueueSimulator]
    # per-type decomposer outputs consumed by the real base circuits
    ram_permutation: "RamPermutationArtifacts" = None
    events_sorter: "EventsCircuitArtifacts" = None
    l1_messages_sorter: "EventsCircuitArtifacts" = None
    log_demuxer: "DemuxCircuitArtifacts" = None
    decommitts_sorter: "DecommittsCircuitArtifacts" = None
    storage_sorter: "StorageCircuitArtifacts" = None
    keccak_rounds: "RoundFunctionCircuitArtifacts" = None
    sha256_rounds: "RoundFunctionCircuitArtifacts" = None
    linear_hasher: "LinearHasherCircuitArtifacts" = None
    code_decommitter: "CodeDecommitterCircuitArtifacts" = None
    main_vm: "VmCircuitArtifacts" = None
    ecrecover: List = None  # [EcrecoverInstanceWitness]
    storage_application: "StorageApplicationCircuitArtifacts" = None
    # callstack sponge witnesses + per-frame log boundary states
    # (witness/callstack_sim.py; oracle.rs:560-790 role)
    callstack_witness: "CallstackSimResult" = None


def _instances_for(count: int, capacity: int) -> int:
    return max(1, -(-count // capacity))


def demux_log_queue(queue: List[Tuple[int, LogQuery]]
                    ) -> Dict[str, List[Tuple[int, LogQuery]]]:
    """Split by class (log_demux.rs): storage, events, L1 msgs, and the three
    precompile streams by address."""
    out: Dict[str, List[Tuple[int, LogQuery]]] = {
        "storage": [], "events": [], "l1": [],
        "keccak": [], "sha256": [], "ecrecover": [],
    }
    for cycle, q in queue:
        if q.aux_byte == AUX_BYTE_STORAGE:
            out["storage"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_EVENT:
            out["events"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_L1_MESSAGE:
            out["l1"].append((cycle, q))
        elif q.aux_byte == AUX_BYTE_PRECOMPILE:
            if q.address == DefaultPrecompilesProcessor.KECCAK_ADDRESS:
                out["keccak"].append((cycle, q))
            elif q.address == DefaultPrecompilesProcessor.SHA256_ADDRESS:
                out["sha256"].append((cycle, q))
            else:
                out["ecrecover"].append((cycle, q))
    return out


def dedup_events(events: List[LogQuery]) -> List[LogQuery]:
    """Cancel (forward, rollback) pairs by timestamp; keep net events in
    original order (events_sort_dedup.rs behavior)."""
    rolled_back = {q.timestamp for q in events if q.rollback}
    return [q for q in events
            if not q.rollback and q.timestamp not in rolled_back]


def _calls(tracer: WitnessTracer, address: int) -> List[bytes]:
    return [data for (_, q, data, _r) in tracer.precompile_calls
            if q.address == address]


def create_artifacts_from_tracer(tracer: WitnessTracer,
                                 geometry: GeometryConfig,
                                 initial_storage=None,
                                 device=None) -> BlockArtifacts:
    """initial_storage: optional {(shard, address, key): value} pre-state
    (predeployed contracts etc.) seeded into the storage-application tree
    before the block's writes are applied."""
    from .callstack_sim import simulate_callstack
    from .decommitter import compute_code_decommitter_artifacts
    from .ecrecover_witness import ecrecover_decompose
    from .linear_hasher import compute_hasher_circuit_artifacts
    from .log_demux import compute_log_demux_artifacts
    from .main_vm import compute_main_vm_artifacts, crosscheck_query_binding
    from .precompile_circuits import (compute_keccak_circuit_artifacts,
                                      compute_sha256_circuit_artifacts)
    from .ram_permutation import compute_ram_circuit_snapshots
    from .sorters import (compute_decommitts_circuit_artifacts,
                          compute_events_circuit_artifacts,
                          compute_storage_circuit_artifacts)
    from .storage_application import (compute_storage_application_artifacts,
                                      storage_key_to_index)
    from .storage_sort import sort_storage_access_queries
    from .tree import SparseStorageTree
    from ..prover.layers import main_vm_geometry_for_capacity
    device = gl.resolve_device(device)
    g = geometry

    # 1. full log queue through the Poseidon2 simulator
    log_entries = tracer.final_log_queue()
    with tracing.span("oracle.queues"):
        log_queue = QueueSimulator(device=device)
        log_queue.push_many([encode_log_query(q) for _, q in log_entries])

        # 2. demux
        demuxed = demux_log_queue(log_entries)

        # 3. memory queues (unsorted + sorted by (page, index, timestamp) —
        # the reference's memory sorting key, memory_query.rs:6-14)
        memory_queue = FullWidthQueueSimulator(device=device)
        memory_queue.push_many([encode_memory_query(q)
                                for _, q in tracer.memory_queries])
        sorted_mem = sorted((q for _, q in tracer.memory_queries),
                            key=memory_sorting_key)
        sorted_memory_queue = FullWidthQueueSimulator(device=device)
        sorted_memory_queue.push_many([encode_memory_query(q)
                                       for q in sorted_mem])
        # the chains run here, so that the span holds them
        for q in (log_queue, memory_queue, sorted_memory_queue):
            q.tails()

    # 4. dedups
    storage_qs = [q for _, q in demuxed["storage"]]
    _, dedup_storage = sort_storage_access_queries(storage_qs)
    dedup_ev = dedup_events([q for _, q in demuxed["events"]])
    dedup_l1 = dedup_events([q for _, q in demuxed["l1"]])

    # 5. every decomposer at the geometry's capacities
    with tracing.span("oracle.events_sorter"):
        ev_art = compute_events_circuit_artifacts(
            [q for _, q in demuxed["events"]],
            g.cycles_per_events_or_l1_messages_sorter, circuit_type=11,
            device=device)
    with tracing.span("oracle.l1_messages_sorter"):
        l1_art = compute_events_circuit_artifacts(
            [q for _, q in demuxed["l1"]],
            g.cycles_per_events_or_l1_messages_sorter, circuit_type=12,
            device=device)
    with tracing.span("oracle.log_demuxer"):
        demux_art = compute_log_demux_artifacts(
            [q for _, q in log_entries], g.cycles_per_log_demuxer,
            device=device)
    with tracing.span("oracle.decommitts_sorter"):
        decommitts_art = compute_decommitts_circuit_artifacts(
            [q for _, q in tracer.decommittment_queries],
            g.cycles_per_code_decommitter_sorter, device=device)
    with tracing.span("oracle.storage_sorter"):
        storage_art = compute_storage_circuit_artifacts(
            storage_qs, g.cycles_per_storage_sorter, device=device)
    with tracing.span("oracle.keccak_rounds"):
        keccak_art = compute_keccak_circuit_artifacts(
            _calls(tracer, DefaultPrecompilesProcessor.KECCAK_ADDRESS),
            g.cycles_per_keccak256_circuit, device=device)
    with tracing.span("oracle.sha256_rounds"):
        sha256_art = compute_sha256_circuit_artifacts(
            _calls(tracer, DefaultPrecompilesProcessor.SHA256_ADDRESS),
            g.cycles_per_sha256_circuit, device=device)
    with tracing.span("oracle.linear_hasher"):
        hasher_art = compute_hasher_circuit_artifacts(
            dedup_l1, g.limit_for_l1_messages_pudata_hasher, device=device)
    with tracing.span("oracle.code_decommitter"):
        code_dec_art = compute_code_decommitter_artifacts(
            [q for _, q in tracer.decommittment_queries if q.is_fresh],
            tracer.decommitted_bytecodes, device=device)
    with tracing.span("oracle.main_vm"):
        vm_geo = main_vm_geometry_for_capacity(g.cycles_per_vm_snapshot)
        main_vm_art = compute_main_vm_artifacts(
            tracer, vm_geo, g.cycles_per_vm_snapshot, device=device)
        # cross-circuit glue: the MainVM accumulator PIs must re-derive
        # from the SAME traced query objects the RAM-permutation / log-demux
        # circuits consume
        crosscheck_query_binding(tracer, vm_geo, main_vm_art)
    with tracing.span("oracle.ecrecover"):
        ecrecover_art = ecrecover_decompose(
            _calls(tracer, DefaultPrecompilesProcessor.ECRECOVER_ADDRESS),
            g.cycles_per_ecrecover_circuit)
    with tracing.span("oracle.storage_application"):
        pre_tree = SparseStorageTree(
            depth=getattr(g, "storage_tree_depth", 256))
        for (shard, address, key), value in sorted(
                (initial_storage or {}).items()):
            if shard == 0 and value:
                pre_tree.insert_leaf(storage_key_to_index(address, key),
                                     int(value).to_bytes(32, "big"))
        storage_app_art = compute_storage_application_artifacts(
            pre_tree, dedup_storage, g.cycles_per_storage_application)
    # instances per type: the decomposer's own split where it has one
    # (the events / L1 sorters' safe splits may exceed ceil(count /
    # capacity)), else the element count over the capacity; at least one
    T = BaseLayerCircuitType

    def split(ctype, count):
        return _instances_for(count, base_capacity(g, ctype))

    num_instances = {
        T.MAIN_VM: len(main_vm_art.instances),
        T.CODE_DECOMMITTMENTS_SORTER: split(
            T.CODE_DECOMMITTMENTS_SORTER, len(tracer.decommittment_queries)),
        T.CODE_DECOMMITTER: len(code_dec_art.instances),
        T.LOG_DEMUXER: len(demux_art.instances),
        T.KECCAK_ROUND_FUNCTION: len(keccak_art.instances),
        T.SHA256_ROUND_FUNCTION: len(sha256_art.instances),
        T.ECRECOVER: split(T.ECRECOVER, len(demuxed["ecrecover"])),
        T.RAM_PERMUTATION: split(T.RAM_PERMUTATION,
                                 len(tracer.memory_queries)),
        T.STORAGE_SORTER: len(storage_art.instances),
        T.STORAGE_APPLICATION: split(T.STORAGE_APPLICATION,
                                     len(dedup_storage)),
        T.EVENTS_SORTER: len(ev_art.instances),
        T.L1_MESSAGES_SORTER: len(l1_art.instances),
        T.L1_MESSAGES_HASHER: split(T.L1_MESSAGES_HASHER, len(dedup_l1)),
    }
    per_circuit: Dict[int, PerCircuitArtifacts] = {}
    recursion_queues: Dict[int, RecursionQueueSimulator] = {}
    with tracing.span("oracle.recursion_queues"):
        for ctype, n in num_instances.items():
            n_inst = max(1, n)
            per_circuit[int(ctype)] = PerCircuitArtifacts(
                queue=QueueSimulator(device=device), num_instances=n_inst,
                capacity=base_capacity(g, ctype))
            rq = RecursionQueueSimulator(device=device)
            for idx in range(n_inst):
                # public input placeholder: the commitment is filled in when
                # the instance is proven (CircuitMaker parity,
                # postprocessing/mod.rs:94-420)
                rq.push_request(RecursionRequest(int(ctype), (idx, 0, 0, 0)))
            recursion_queues[int(ctype)] = rq

    with tracing.span("oracle.ram_permutation"):
        ram_art = compute_ram_circuit_snapshots(
            [q for _, q in tracer.memory_queries],
            g.cycles_per_ram_permutation, device=device)

    with tracing.span("oracle.callstack"):
        callstack_wit = simulate_callstack(tracer, device=device)

    return BlockArtifacts(
        log_queue=log_queue, demuxed=demuxed, memory_queue=memory_queue,
        sorted_memory_queue=sorted_memory_queue,
        deduplicated_storage=dedup_storage, deduplicated_events=dedup_ev,
        deduplicated_l1_messages=dedup_l1, per_circuit=per_circuit,
        recursion_queues=recursion_queues, ram_permutation=ram_art,
        events_sorter=ev_art, l1_messages_sorter=l1_art,
        log_demuxer=demux_art, decommitts_sorter=decommitts_art,
        storage_sorter=storage_art, keccak_rounds=keccak_art,
        sha256_rounds=sha256_art, linear_hasher=hasher_art,
        code_decommitter=code_dec_art, main_vm=main_vm_art,
        ecrecover=ecrecover_art, storage_application=storage_app_art,
        callstack_witness=callstack_wit)


def block_payloads(art, geometry: GeometryConfig
                   ) -> Dict[int, Tuple[List, object, int]]:
    """Per base circuit type: (decomposer instances, binding challenges or
    None, capacity), the payloads `prover.layers.prove_base_instance`
    proves (the JAX package's `harness.py` real payloads). Type 10's
    (read, write) pairs flatten into single paths, each proved as one
    instance; type 7's instances are the ecrecover decomposer's."""
    payloads = {
        1: (art.main_vm.instances, None),
        2: (art.decommitts_sorter.instances, art.decommitts_sorter.challenges),
        3: (art.code_decommitter.instances, None),
        4: (art.log_demuxer.instances, None),
        5: (art.keccak_rounds.instances,
            (art.keccak_rounds.challenges, art.keccak_rounds.gammas)),
        6: (art.sha256_rounds.instances,
            (art.sha256_rounds.challenges, art.sha256_rounds.gammas)),
        7: (art.ecrecover, None),
        8: (art.ram_permutation.instances, art.ram_permutation.challenges),
        9: (art.storage_sorter.instances, art.storage_sorter.challenges),
        10: ([p for pair in art.storage_application.instances
              for p in pair], None),
        11: (art.events_sorter.instances, art.events_sorter.challenges),
        12: (art.l1_messages_sorter.instances,
             art.l1_messages_sorter.challenges),
        13: (art.linear_hasher.instances, None),
    }
    return {t: (insts, ch, base_capacity(geometry, t))
            for t, (insts, ch) in payloads.items()}
