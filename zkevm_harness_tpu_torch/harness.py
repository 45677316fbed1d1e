"""Block-level proving flow: the `external_calls::run` + basic_test analogue.

Counterpart of the JAX package's `harness.py`. Ties the pipeline together:
  run VM -> tracer -> oracle artifacts -> per-circuit CircuitMakers (closed
  form inputs + PI commitments) -> recursion queues -> proof DAG ->
  base/leaf/node/scheduler proving -> scheduler witness assembly.

`prove_mode` controls the per-task work, mirroring the reference's tiers:
  - "full": real PLONKish proofs of every type;
  - "spot": real proofs for `spot_types` only, metadata for the rest;
  - "dry": metadata everywhere (DAG/pipeline validation).

The base proofs come from `layers.prove_base_instance` /
`verify_base_instance` over the payloads of `witness.oracle.block_payloads`
(one per-type table where the JAX package keeps a dispatch of its own).
Everything runs on `device` (`None`: the CUDA card, raising where there is
none). A run records its stages' host seconds in `timings` and, per
recursion proof, its shape and the seconds of synthesis, finalize, fill,
setup, prove and verify in `tower_stats` (with the peak device memory and
the kernel launches of the task on a CUDA device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

from .circuits import leaf_circuit as lc
from .circuits import node_circuit as nc
from .circuits import scheduler_circuit as sc_circ
from .circuits.types import GeometryConfig, testing_geometry
from .ops import goldilocks as gl
from .prover import layers as ly
from .prover import plonkish as pk
from .prover import scheduler as sch
from .utils import tracing
from .utils.data_source import InMemoryDataSource
from .vm import isa
from .vm.environment import (DefaultPrecompilesProcessor, InMemoryEventSink,
                             InMemoryStorage, SimpleDecommitter, SimpleMemory)
from .vm.interpreter import deploy_contract, run_vm
from .vm.state import BlockProperties, ProvingToolset, create_vm
from .witness import closed_form as cf
from .witness import oracle as orc
from .witness import postprocessing as pp
from .witness import scheduler_witness as sw
from .witness.recursion import RECURSION_ARITY
from .witness.tracer import WitnessTracer

P = gl.P


@dataclasses.dataclass
class BlockProvingResult:
    cycles: int
    artifacts: orc.BlockArtifacts
    circuit_makers: Dict[int, pp.CircuitMaker]
    dag_results: Dict
    scheduler_witness: sw.SchedulerCircuitInstanceWitness
    source: InMemoryDataSource
    recursion_rigs: Dict = dataclasses.field(default_factory=dict)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    tower_stats: Dict = dataclasses.field(default_factory=dict)


def _ir_shape(ir: pk.PlonkishIR, builder=None) -> Dict:
    out = {"log_n": ir.log_n, "width": ir.num_witness,
           "public_inputs": len(ir.public_input_cells)}
    if builder is not None:
        out.update(gates=builder.num_gates, permutations=len(builder.perms))
    return out


def run_block(code: Sequence[isa.Instruction], entry_address: int = 0xAA,
              geometry: Optional[GeometryConfig] = None,
              cycle_limit: int = 10_000,
              prove_mode: str = "dry",
              spot_types: Sequence[int] = (),
              source: Optional[InMemoryDataSource] = None,
              contracts: Optional[Dict[int, Sequence[isa.Instruction]]] = None,
              tower: bool = False,
              recursion_cfg=None,
              leaf_arity: Optional[int] = None,
              block_number: int = 1,
              eip4844_outputs=(),
              eip4844_slots=(),
              device=None) -> BlockProvingResult:
    """With `tower=True` the DAG's leaf/node/scheduler tasks are REAL
    proofs (not metadata): each leaf verifies its base-proof chunk
    in-circuit against the task's recursion-queue segment, nodes splice
    leaf intervals, and the scheduler verifies every real type's final
    node, all through run_dag, so skip-if-present resume applies to the
    whole tower (the reference's basic_test protocol,
    complex_tests/mod.rs:323-331,588-592). Tower tasks follow the same
    real-proof eligibility as base tasks ("full" = all types, "spot" =
    spot_types).

    `eip4844_slots`: per-blob dicts {"ir", "cfg", "vk", "proof"} of
    already-proven blob fold proofs; the scheduler task grows one
    in-circuit verifier slot per blob."""
    device = gl.resolve_device(device)
    geometry = geometry or testing_geometry()
    source = source or InMemoryDataSource()
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        timings[name + "_s"] = now - t0
        t0 = now

    # -- L0/L1: execute and trace -----------------------------------------
    tracer = WitnessTracer(geometry.cycles_per_vm_snapshot)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=geometry)
    for addr, instrs in (contracts or {}).items():
        deploy_contract(tools, addr, instrs)
    pre_state = dict(tools.storage.inner)  # post-predeploy, pre-execution
    vm = create_vm(tools, BlockProperties(block_number=1), entry_address,
                   code_page=0)
    cycles = run_vm(vm, list(code), cycle_limit)
    assert vm.finished, "block did not finish within the cycle limit"
    lap("trace")

    # -- L2: witness artifacts --------------------------------------------
    artifacts = orc.create_artifacts_from_tracer(
        tracer, geometry, initial_storage=pre_state, device=device)
    # per-type instance payloads + binding challenges (the decomposer's
    # output, consumed by both the CircuitMaker pass and real proving)
    real_payloads = orc.block_payloads(artifacts, geometry)
    lap("artifacts")

    # -- CircuitMaker pass: REAL closed-form inputs + recursion queues -----
    # the recursion-queue digest is the Poseidon2 hash of the instance's
    # REAL public-input vector, the value the leaf circuit re-verifies
    # in-circuit (postprocessing/mod.rs:136-294 parity)
    makers: Dict[int, pp.CircuitMaker] = {}
    for ctype, (insts, challenges, cap) in real_payloads.items():
        cm = pp.CircuitMaker(ctype, device=device)
        for idx, inst_w in enumerate(insts):
            pis = ly.real_base_instance_public_inputs(ctype, inst_w,
                                                      challenges, cap)
            cfi = cf.build_closed_form(ctype, inst_w, challenges,
                                       is_first=(idx == 0),
                                       is_last=(idx == len(insts) - 1))
            cm.process_real(cfi, pis, witness_payload=inst_w)
        makers[ctype] = cm
        artifacts.recursion_queues[ctype] = cm.queue
        # the decomposer's instance count is authoritative
        artifacts.per_circuit[ctype].num_instances = len(insts)
    lap("circuit_makers")

    # -- L5: proof DAG -----------------------------------------------------
    dag = sch.build_block_dag(
        {t: m.queue for t, m in makers.items()},
        {t: a.num_instances for t, a in artifacts.per_circuit.items()},
        leaf_arity=leaf_arity)
    # scheduler witness assembled BEFORE the DAG runs: the real scheduler
    # task consumes its aux values in-circuit
    first_last = {t: (m.first, m.last) for t, m in makers.items()}
    sched_wit = sw.assemble_scheduler_witness(
        block_number, artifacts, first_last,
        eip4844_output_hashes=tuple(eip4844_outputs))
    lap("dag_build")

    # recursion rigs (tower=True): synthesized circuits, keyed so the
    # scheduler task and the caller can retrieve (ir, vk) per stage
    rec_cfg = recursion_cfg or pk.PlonkishConfig(
        rate=2, cap_size=4, num_queries=2, final_fri_size=8)
    rigs: Dict = {}
    stats: Dict = {}
    eff_arity = leaf_arity or RECURSION_ARITY

    def _eligible(base_t: int) -> bool:
        return prove_mode == "full" or (prove_mode == "spot"
                                        and base_t in spot_types)

    def _type_is_ragged(base_t: int) -> bool:
        """A type whose queue splits into MULTIPLE chunks with a short
        tail chunk needs ONE shared (padded) leaf circuit so all its
        leaves (and hence the node's children) share a VK (the
        reference's padding-proof protocol,
        recursive_aggregation.rs:385-389)."""
        n = artifacts.per_circuit[base_t].num_instances
        return n > eff_arity and n % eff_arity != 0

    def _leaf_rig(base_t: int, k: int, padded: bool,
                  watch: tracing.Stopwatch):
        key = ("leaf", base_t, k, padded)
        if key not in rigs:
            sd = ly.base_setup_for_type(base_t, geometry, device=device)
            b, lay = lc.synthesize_leaf(sd.ir, sd.config, arity=k,
                                        base_circuit_type=base_t,
                                        padded=padded)
            watch.lap("synthesis")
            built = b.finalize()
            watch.lap("finalize")
            setup = built.setup(rec_cfg, device=device)
            watch.lap("setup")
            rigs[key] = (b, lay, built, setup, sd)
        return rigs[key]

    def _node_rig(base_t: int, k: int, child_ir,
                  watch: tracing.Stopwatch):
        key = ("node", base_t, k, id(child_ir))
        if key not in rigs:
            nb, nlay = nc.synthesize_node(child_ir, rec_cfg, arity=k)
            watch.lap("synthesis")
            nbuilt = nb.finalize()
            watch.lap("finalize")
            nsetup = nbuilt.setup(rec_cfg, device=device)
            watch.lap("setup")
            rigs[key] = (nb, nlay, nbuilt, nsetup)
        return rigs[key]

    def _prove_and_check(what, ir, setup, W, expect, watch):
        proof = pk.prove(ir, setup, W, rec_cfg, device=device)
        watch.lap("prove")
        assert [int(v) for v in proof.public_inputs] == \
            [int(v) % P for v in expect], f"{what} PI mismatch"
        ok = pk.verify(ir, setup.vk(), proof, rec_cfg, device=device)
        watch.lap("verify")
        assert ok, f"{what} proof failed verification"
        return proof

    def _prove_leaf(task, deps):
        watch = tracing.Stopwatch(device)
        lw = task.payload
        base_t = lw.base_circuit_type
        chunk = [deps[d.key()]["proof"] for d in task.deps]
        padded = _type_is_ragged(base_t)
        synth_arity = eff_arity if padded else len(chunk)
        b, lay, built, setup, sd = _leaf_rig(base_t, synth_arity, padded,
                                             watch)
        padding = None
        if padded and len(chunk) < synth_arity:
            # reference protocol: instance 0's proof is the type's padding
            # proof (complex_tests/mod.rs:326,395)
            prec = source.get_base_layer_proof(base_t, 0)
            padding = prec["proof"] if prec else chunk[0]
            if source.get_base_layer_padding_proof(base_t) is None:
                source.set_base_layer_padding_proof(
                    {"kind": "base_padding", "real": True,
                     "proof": padding}, base_t)
        W = b.fill_witness(lc.leaf_assignments(lay, sd.vk, chunk,
                                               queue_head=lw.queue_head,
                                               padding_proof=padding),
                           device=device)
        watch.lap("fill")
        expect = lc.leaf_public_inputs(lay, sd.vk, chunk,
                                       queue_head=lw.queue_head,
                                       device=device)
        proof = _prove_and_check(f"leaf {base_t}", built.ir, setup, W,
                                 expect, watch)
        del W
        assert tuple(int(v) for v in proof.public_inputs[-12:]) == \
            tuple(int(v) % P for v in lw.queue_tail), \
            "leaf tail diverged from its recursion-queue segment"
        rigs[("leaf_final", base_t)] = (built.ir, setup.vk())
        stats[task.key()] = watch.done(**_ir_shape(built.ir, b),
                                       arity=synth_arity)
        return {"kind": "leaf", "real": True, "circuit_type": base_t,
                "proof": proof, "vk": setup.vk(), "arity": synth_arity,
                "num_real": len(chunk),
                "public_inputs": proof.public_inputs}

    def _ensure_leaf_final(base_t: int, k: int, vk):
        """Re-synthesize the leaf rig after a resume skipped the leaf task
        (synthesis is deterministic in (base ir, cfg, arity, raggedness))."""
        if ("leaf_final", base_t) not in rigs:
            _b, _lay, built, setup, _sd = _leaf_rig(
                base_t, k, _type_is_ragged(base_t),
                tracing.Stopwatch(device))
            assert setup.vk() == list(vk), \
                "resumed leaf VK does not match the re-synthesized circuit"
            rigs[("leaf_final", base_t)] = (built.ir, setup.vk())

    def _prove_node(task, deps):
        watch = tracing.Stopwatch(device)
        base_t = task.circuit_type
        children = [deps[d.key()] for d in task.deps]
        child_kind = task.deps[0].kind
        if child_kind == "leaf":
            _ensure_leaf_final(base_t, children[0]["arity"],
                               children[0]["vk"])
            child_ir, _ = rigs[("leaf_final", base_t)]
        else:
            child_ir, _ = rigs[("node_final", base_t)]
        child_vk = children[0]["vk"]
        assert all(c["vk"] == child_vk for c in children), \
            "node children must share one VK"
        child_proofs = [c["proof"] for c in children]
        nb, nlay, nbuilt, nsetup = _node_rig(base_t, len(children),
                                             child_ir, watch)
        nW = nb.fill_witness(nc.node_assignments(nlay, child_vk,
                                                 child_proofs),
                             device=device)
        watch.lap("fill")
        nexpect = nc.node_public_inputs(nlay, child_vk, child_proofs)
        proof = _prove_and_check(f"node {base_t}", nbuilt.ir, nsetup, nW,
                                 nexpect, watch)
        del nW
        rigs[("node_final", base_t)] = (nbuilt.ir, nsetup.vk())
        stats[task.key()] = watch.done(**_ir_shape(nbuilt.ir, nb),
                                       arity=len(children))
        return {"kind": "node", "real": True, "circuit_type": base_t,
                "proof": proof, "vk": nsetup.vk(), "arity": len(children),
                "public_inputs": proof.public_inputs}

    def _prove_scheduler(task, deps):
        real_types = sorted(d.circuit_type for d in task.deps
                            if deps[d.key()].get("real"))
        node_recs = {d.circuit_type: deps[d.key()] for d in task.deps
                     if deps[d.key()].get("real")}
        aux = sc_circ.scheduler_aux_values(sched_wit)
        for t in real_types:
            if ("node_final", t) not in rigs:
                # resumed node: re-synthesize its rig (single node level at
                # this scale; deeper towers resume from the node records)
                leaf_rec = source.get_leaf_layer_proof(t + 2, 0)
                assert leaf_rec and leaf_rec.get("real")
                _ensure_leaf_final(t, leaf_rec["arity"], leaf_rec["vk"])
                child_ir, _ = rigs[("leaf_final", t)]
                _nb, _nl, nbuilt, nsetup = _node_rig(
                    t, node_recs[t]["arity"], child_ir,
                    tracing.Stopwatch(device))
                assert nsetup.vk() == list(node_recs[t]["vk"])
                rigs[("node_final", t)] = (nbuilt.ir, nsetup.vk())
        watch = tracing.Stopwatch(device)
        shapes = [(rigs[("node_final", t)][0], rec_cfg) for t in real_types]
        blob_shapes = [(s["ir"], s["cfg"]) for s in eip4844_slots]
        blob_vks = [s["vk"] for s in eip4844_slots]
        blob_prfs = [s["proof"] for s in eip4844_slots]
        sb, slay = sc_circ.synthesize_scheduler_multi(
            shapes, type_ids=tuple(real_types), aux_len=len(aux),
            blob_children=blob_shapes)
        watch.lap("synthesis")
        sbuilt = sb.finalize()
        watch.lap("finalize")
        node_vks = [node_recs[t]["vk"] for t in real_types]
        node_prfs = [node_recs[t]["proof"] for t in real_types]
        sW = sb.fill_witness(sc_circ.scheduler_multi_assignments(
            slay, node_vks, node_prfs, block_number, aux,
            blob_vks=blob_vks, blob_proofs=blob_prfs), device=device)
        watch.lap("fill")
        ssetup = sbuilt.setup(rec_cfg, device=device)
        watch.lap("setup")
        sched_pi = sc_circ.scheduler_multi_public_inputs(
            slay, node_vks, node_prfs, block_number, aux,
            blob_vks=blob_vks, blob_proofs=blob_prfs, device=device)
        proof = _prove_and_check("scheduler", sbuilt.ir, ssetup, sW,
                                 sched_pi, watch)
        rigs[("scheduler",)] = (sbuilt.ir, ssetup.vk())
        rigs[("scheduler_witness",)] = (sb, slay, sbuilt, ssetup, sW)
        stats[task.key()] = watch.done(**_ir_shape(sbuilt.ir, sb),
                                       types=real_types)
        return {"kind": "scheduler", "real": True, "proof": proof,
                "vk": ssetup.vk(), "types": real_types,
                "public_inputs": proof.public_inputs,
                "num_blob_slots": len(eip4844_slots),
                "scheduler_pi": [int(v) % P for v in sched_pi]}

    def prove_fn(task: sch.ProofTask, deps):
        # leaf tasks carry the RECURSION-layer circuit type; eligibility is
        # decided by the BASE type they aggregate
        if tower and task.kind == "leaf" and \
                _eligible(task.payload.base_circuit_type):
            return _prove_leaf(task, deps)
        if tower and task.kind == "node" and _eligible(task.circuit_type):
            return _prove_node(task, deps)
        if tower and task.kind == "scheduler" and any(
                deps[d.key()].get("real") for d in task.deps):
            return _prove_scheduler(task, deps)
        real = (prove_mode == "full" or
                (prove_mode == "spot" and task.kind == "base"
                 and task.circuit_type in spot_types))
        if real and task.kind == "base":
            ctype = task.circuit_type
            instances, challenges, cap = real_payloads[ctype]
            if task.index < len(instances):
                watch = tracing.Stopwatch(device)
                inst_w = instances[task.index]
                proof = ly.prove_base_instance(ctype, inst_w, challenges,
                                               cap, source, device)
                watch.lap("prove")
                assert ly.verify_base_instance(
                    ctype, inst_w, challenges, cap, proof, device), \
                    "verify-after-prove failed"
                watch.lap("verify")
                stats[task.key()] = watch.done()
                return {"kind": task.kind, "real": True,
                        "circuit_type": ctype, "proof": proof,
                        "public_inputs": proof.public_inputs}
            # empty argument: no decomposer instance to prove
            return {"kind": task.kind, "circuit_type": ctype,
                    "index": task.index, "ndeps": len(deps),
                    "real": False, "empty": True}
        return {"kind": task.kind, "circuit_type": task.circuit_type,
                "index": task.index, "ndeps": len(deps), "real": False}

    dag_results = sch.run_dag(dag, prove_fn, source)
    lap("dag_run")

    return BlockProvingResult(cycles=cycles, artifacts=artifacts,
                              circuit_makers=makers, dag_results=dag_results,
                              scheduler_witness=sched_wit, source=source,
                              recursion_rigs=rigs, timings=timings,
                              tower_stats=stats)
