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

An option of the port's own, for the whole block's tower at production
widths, leaves every proof as it is: `type_workers=k` proves each type's
base, leaf and node tasks in k processes of their own on the same device
(the host's circuit synthesis, the larger part of a leaf's time, then runs
k at a time; each process holds one type's circuits at a time, a leaf none
of its base setup, and one lock keeps the processes' device-heavy steps
apart), the types with the most expected work first; and the scheduler
here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import time
from typing import Dict, Optional, Sequence

import torch

from .circuits import builder as bd
from .circuits import leaf_circuit as lc
from .circuits import node_circuit as nc
from .circuits import scheduler_circuit as sc_circ
from .circuits.types import GeometryConfig, testing_geometry
from .ops import cuda_kernels as ck
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
    # kernel launches made in `type_workers` processes, by kernel
    worker_launches: Dict[str, int] = dataclasses.field(default_factory=dict)


def _ir_shape(ir: pk.PlonkishIR, builder=None) -> Dict:
    out = {"log_n": ir.log_n, "width": ir.num_witness,
           "public_inputs": len(ir.public_input_cells)}
    if builder is not None:
        out.update(gates=builder.num_gates, permutations=len(builder.perms))
    return out


@dataclasses.dataclass(frozen=True)
class _BaseCircuit:
    """What a leaf needs of the base circuit it verifies."""
    ir: pk.PlonkishIR
    config: pk.PlonkishConfig
    vk: list


def _expected_leaf_work(ctype: int, instances: int, geometry) -> int:
    """A type's expected leaf work: its base instances times the columns
    (witness and constant) of its base circuit. A leaf hashes and checks
    every column a base proof opens, so its gates go with them: in the
    whole block's production tower 3.8 to 7.0 thousand a column of the
    base circuit, and its synthesis, finalize and fill, most of a type's
    subtree, with its gates."""
    ir = ly.base_ir_for_type(ctype, geometry)
    return instances * (ir.num_witness + ir.num_const)


def _task_type(task: sch.ProofTask) -> int:
    """The base circuit type a base, leaf or node task belongs to."""
    return (task.payload.base_circuit_type if task.kind == "leaf"
            else task.circuit_type)


class _BlockFlow:
    """One block's proving flow: the trace, the artifacts, the CircuitMaker
    pass and the DAG on construction, then `prove_fn` for `run_dag`."""

    def __init__(self, code, entry_address, geometry, cycle_limit,
                 prove_mode, spot_types, source, contracts, tower,
                 recursion_cfg, leaf_arity, block_number, eip4844_outputs,
                 eip4844_slots, device, device_lock=None):
        self.device = device = gl.resolve_device(device)
        self.geometry = geometry = geometry or testing_geometry()
        self.source = source if source is not None else InMemoryDataSource()
        self.prove_mode, self.spot_types = prove_mode, tuple(spot_types)
        self.tower = tower
        self.block_number = block_number
        self.eip4844_slots = eip4844_slots
        # a worker of `type_workers`: the lock shared with the other
        # workers, and one type's circuits held at a time
        self.device_lock = device_lock
        self.timings: Dict[str, float] = {}
        self._t0 = time.perf_counter()

        # -- L0/L1: execute and trace -------------------------------------
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
        self.cycles = run_vm(vm, list(code), cycle_limit)
        assert vm.finished, "block did not finish within the cycle limit"
        self.lap("trace")

        # -- L2: witness artifacts ----------------------------------------
        artifacts = orc.create_artifacts_from_tracer(
            tracer, geometry, initial_storage=pre_state, device=device)
        # per-type instance payloads + binding challenges (the decomposer's
        # output, consumed by both the CircuitMaker pass and real proving)
        self.real_payloads = orc.block_payloads(artifacts, geometry)
        self.artifacts = artifacts
        self.lap("artifacts")

        # -- CircuitMaker pass: REAL closed-form inputs + recursion queues -
        # the recursion-queue digest is the Poseidon2 hash of the instance's
        # REAL public-input vector, the value the leaf circuit re-verifies
        # in-circuit (postprocessing/mod.rs:136-294 parity)
        makers: Dict[int, pp.CircuitMaker] = {}
        for ctype, (insts, challenges, cap) in self.real_payloads.items():
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
        self.makers = makers
        self.lap("circuit_makers")

        # -- L5: proof DAG -------------------------------------------------
        self.dag = sch.build_block_dag(
            {t: m.queue for t, m in makers.items()},
            {t: a.num_instances for t, a in artifacts.per_circuit.items()},
            leaf_arity=leaf_arity)
        # scheduler witness assembled BEFORE the DAG runs: the real
        # scheduler task consumes its aux values in-circuit
        first_last = {t: (m.first, m.last) for t, m in makers.items()}
        self.sched_wit = sw.assemble_scheduler_witness(
            block_number, artifacts, first_last,
            eip4844_output_hashes=tuple(eip4844_outputs))
        self.final_nodes = {d.key() for d in self.dag[-1].deps}
        self.lap("dag_build")

        # recursion rigs (tower=True): synthesized circuits, keyed so the
        # scheduler task and the caller can retrieve (ir, vk) per stage
        self.rec_cfg = recursion_cfg or pk.PlonkishConfig(
            rate=2, cap_size=4, num_queries=2, final_fri_size=8)
        self.rigs: Dict = {}
        self.ir_shapes: Dict = {}
        self.stats: Dict = {}
        self.eff_arity = leaf_arity or RECURSION_ARITY

    def lap(self, name):
        now = time.perf_counter()
        self.timings[name + "_s"] = now - self._t0
        self._t0 = now

    def eligible(self, base_t: int) -> bool:
        return self.prove_mode == "full" or (self.prove_mode == "spot"
                                             and base_t in self.spot_types)

    @contextlib.contextmanager
    def device_section(self, watch: tracing.Stopwatch):
        """A device-heavy step: under the lock shared with the other
        processes of the block (`type_workers`), whose wait is the
        task's `device_wait`; the memory it cached is handed back at its
        end, for the other processes."""
        if self.device_lock is None:
            yield
            return
        with self.device_lock:
            watch.lap("device_wait")
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    torch.cuda.empty_cache()

    def _type_is_ragged(self, base_t: int) -> bool:
        """A type whose queue splits into MULTIPLE chunks with a short
        tail chunk needs ONE shared (padded) leaf circuit so all its
        leaves (and hence the node's children) share a VK (the
        reference's padding-proof protocol,
        recursive_aggregation.rs:385-389)."""
        n = self.artifacts.per_circuit[base_t].num_instances
        return n > self.eff_arity and n % self.eff_arity != 0

    def _leaf_rig(self, base_t: int, k: int, padded: bool,
                  watch: tracing.Stopwatch):
        """(builder, layout, built circuit, setup, base) of the type's leaf
        of arity k: `base` is the base circuit's IR, config and VK, all a
        leaf needs of it. A type's leaves follow its base proofs in the
        DAG, so the base setup's tensors are let go of here, before the
        leaf's are made."""
        key = ("leaf", base_t, k, padded)
        if key not in self.rigs:
            sd = ly.base_setup_for_type(base_t, self.geometry,
                                        device=self.device)
            base = _BaseCircuit(ir=sd.ir, config=sd.config, vk=sd.vk)
            ly.drop_setup(sd)
            del sd
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
            b, lay = lc.synthesize_leaf(base.ir, base.config, arity=k,
                                        base_circuit_type=base_t,
                                        padded=padded)
            watch.lap("synthesis")
            built = b.finalize()
            watch.lap("finalize")
            with self.device_section(watch):
                setup = built.setup(self.rec_cfg, device=self.device)
            watch.lap("setup")
            self.rigs[key] = (b, lay, built, setup, base)
        return self.rigs[key]

    def _node_rig(self, base_t: int, k: int, child_ir,
                  watch: tracing.Stopwatch):
        key = ("node", base_t, k, id(child_ir))
        if key not in self.rigs:
            nb, nlay = nc.synthesize_node(child_ir, self.rec_cfg, arity=k)
            watch.lap("synthesis")
            nbuilt = nb.finalize()
            watch.lap("finalize")
            with self.device_section(watch):
                nsetup = nbuilt.setup(self.rec_cfg, device=self.device)
            watch.lap("setup")
            self.rigs[key] = (nb, nlay, nbuilt, nsetup)
        return self.rigs[key]

    def _prove_and_check(self, what, ir, setup, W, expect, watch):
        with self.device_section(watch):
            proof = pk.prove(ir, setup, W, self.rec_cfg, device=self.device)
            watch.lap("prove")
            ok = pk.verify(ir, setup.vk(), proof, self.rec_cfg,
                           device=self.device)
            watch.lap("verify")
        assert [int(v) for v in proof.public_inputs] == \
            [int(v) % P for v in expect], f"{what} PI mismatch"
        assert ok, f"{what} proof failed verification"
        return proof

    def _prove_leaf(self, task, deps):
        watch = tracing.Stopwatch(self.device)
        lw = task.payload
        base_t = lw.base_circuit_type
        chunk = [deps[d.key()]["proof"] for d in task.deps]
        padded = self._type_is_ragged(base_t)
        synth_arity = self.eff_arity if padded else len(chunk)
        b, lay, built, setup, base = self._leaf_rig(base_t, synth_arity,
                                                    padded, watch)
        padding = None
        if padded and len(chunk) < synth_arity:
            # reference protocol: instance 0's proof is the type's padding
            # proof (complex_tests/mod.rs:326,395)
            prec = self.source.get_base_layer_proof(base_t, 0)
            padding = prec["proof"] if prec else chunk[0]
            if self.source.get_base_layer_padding_proof(base_t) is None:
                self.source.set_base_layer_padding_proof(
                    {"kind": "base_padding", "real": True,
                     "proof": padding}, base_t)
        W = b.fill_witness(lc.leaf_assignments(lay, base.vk, chunk,
                                               queue_head=lw.queue_head,
                                               padding_proof=padding),
                           device=self.device)
        watch.lap("fill")
        expect = lc.leaf_public_inputs(lay, base.vk, chunk,
                                       queue_head=lw.queue_head,
                                       device=self.device)
        proof = self._prove_and_check(f"leaf {base_t}", built.ir, setup, W,
                                      expect, watch)
        del W
        assert tuple(int(v) for v in proof.public_inputs[-12:]) == \
            tuple(int(v) % P for v in lw.queue_tail), \
            "leaf tail diverged from its recursion-queue segment"
        self.rigs[("leaf_final", base_t)] = (built.ir, setup.vk())
        self.ir_shapes[("leaf_final", base_t)] = b.ir_shape()
        self.stats[task.key()] = watch.done(**_ir_shape(built.ir, b),
                                            arity=synth_arity,
                                            stage_peaks=dict(pk.STAGE_PEAKS))
        return {"kind": "leaf", "real": True, "circuit_type": base_t,
                "proof": proof, "vk": setup.vk(), "arity": synth_arity,
                "num_real": len(chunk),
                "public_inputs": proof.public_inputs}

    def _ensure_leaf_final(self, base_t: int, k: int, vk):
        """Re-synthesize the leaf rig after a resume skipped the leaf task
        (synthesis is deterministic in (base ir, cfg, arity, raggedness))."""
        if ("leaf_final", base_t) not in self.rigs:
            _b, _lay, built, setup, _base = self._leaf_rig(
                base_t, k, self._type_is_ragged(base_t),
                tracing.Stopwatch(self.device))
            assert setup.vk() == list(vk), \
                "resumed leaf VK does not match the re-synthesized circuit"
            self.rigs[("leaf_final", base_t)] = (built.ir, setup.vk())

    def _prove_node(self, task, deps):
        watch = tracing.Stopwatch(self.device)
        base_t = task.circuit_type
        children = [deps[d.key()] for d in task.deps]
        child_kind = task.deps[0].kind
        if child_kind == "leaf":
            self._ensure_leaf_final(base_t, children[0]["arity"],
                                    children[0]["vk"])
            child_ir, _ = self.rigs[("leaf_final", base_t)]
        else:
            child_ir, _ = self.rigs[("node_final", base_t)]
        child_vk = children[0]["vk"]
        assert all(c["vk"] == child_vk for c in children), \
            "node children must share one VK"
        child_proofs = [c["proof"] for c in children]
        nb, nlay, nbuilt, nsetup = self._node_rig(base_t, len(children),
                                                  child_ir, watch)
        nW = nb.fill_witness(nc.node_assignments(nlay, child_vk,
                                                 child_proofs),
                             device=self.device)
        watch.lap("fill")
        nexpect = nc.node_public_inputs(nlay, child_vk, child_proofs)
        proof = self._prove_and_check(f"node {base_t}", nbuilt.ir, nsetup,
                                      nW, nexpect, watch)
        del nW
        self.rigs[("node_final", base_t)] = (nbuilt.ir, nsetup.vk())
        self.ir_shapes[("node_final", base_t)] = nb.ir_shape()
        self.stats[task.key()] = watch.done(**_ir_shape(nbuilt.ir, nb),
                                            arity=len(children))
        if self.device_lock is not None and task.key() in self.final_nodes:
            for key in [k for k in self.rigs if k[0] in ("leaf", "node")
                        and k[1] == base_t]:
                del self.rigs[key]
            ly._SETUP_CACHE.clear()
        return {"kind": "node", "real": True, "circuit_type": base_t,
                "proof": proof, "vk": nsetup.vk(), "arity": len(children),
                "public_inputs": proof.public_inputs}

    def _prove_scheduler(self, task, deps):
        rigs, source = self.rigs, self.source
        real_types = sorted(d.circuit_type for d in task.deps
                            if deps[d.key()].get("real"))
        node_recs = {d.circuit_type: deps[d.key()] for d in task.deps
                     if deps[d.key()].get("real")}
        aux = sc_circ.scheduler_aux_values(self.sched_wit)
        for t in real_types:
            if ("node_final", t) not in rigs:
                # resumed node: re-synthesize its rig (single node level at
                # this scale; deeper towers resume from the node records)
                leaf_rec = source.get_leaf_layer_proof(t + 2, 0)
                assert leaf_rec and leaf_rec.get("real")
                self._ensure_leaf_final(t, leaf_rec["arity"],
                                        leaf_rec["vk"])
                child_ir, _ = rigs[("leaf_final", t)]
                _nb, _nl, nbuilt, nsetup = self._node_rig(
                    t, node_recs[t]["arity"], child_ir,
                    tracing.Stopwatch(self.device))
                assert nsetup.vk() == list(node_recs[t]["vk"])
                rigs[("node_final", t)] = (nbuilt.ir, nsetup.vk())
        watch = tracing.Stopwatch(self.device)
        rec_cfg, device = self.rec_cfg, self.device
        shapes = [(rigs[("node_final", t)][0], rec_cfg) for t in real_types]
        blob_shapes = [(s["ir"], s["cfg"]) for s in self.eip4844_slots]
        blob_vks = [s["vk"] for s in self.eip4844_slots]
        blob_prfs = [s["proof"] for s in self.eip4844_slots]
        sb, slay = sc_circ.synthesize_scheduler_multi(
            shapes, type_ids=tuple(real_types), aux_len=len(aux),
            blob_children=blob_shapes)
        watch.lap("synthesis")
        sbuilt = sb.finalize()
        watch.lap("finalize")
        node_vks = [node_recs[t]["vk"] for t in real_types]
        node_prfs = [node_recs[t]["proof"] for t in real_types]
        sW = sb.fill_witness(sc_circ.scheduler_multi_assignments(
            slay, node_vks, node_prfs, self.block_number, aux,
            blob_vks=blob_vks, blob_proofs=blob_prfs), device=device)
        watch.lap("fill")
        ssetup = sbuilt.setup(rec_cfg, device=device)
        watch.lap("setup")
        sched_pi = sc_circ.scheduler_multi_public_inputs(
            slay, node_vks, node_prfs, self.block_number, aux,
            blob_vks=blob_vks, blob_proofs=blob_prfs, device=device)
        proof = self._prove_and_check("scheduler", sbuilt.ir, ssetup, sW,
                                      sched_pi, watch)
        rigs[("scheduler",)] = (sbuilt.ir, ssetup.vk())
        rigs[("scheduler_witness",)] = (sb, slay, sbuilt, ssetup, sW)
        self.stats[task.key()] = watch.done(**_ir_shape(sbuilt.ir, sb),
                                            types=real_types)
        return {"kind": "scheduler", "real": True, "proof": proof,
                "vk": ssetup.vk(), "types": real_types,
                "public_inputs": proof.public_inputs,
                "num_blob_slots": len(self.eip4844_slots),
                "scheduler_pi": [int(v) % P for v in sched_pi]}

    def _prove_base(self, task):
        ctype = task.circuit_type
        instances, challenges, cap = self.real_payloads[ctype]
        if task.index >= len(instances):
            # empty argument: no decomposer instance to prove
            return {"kind": task.kind, "circuit_type": ctype,
                    "index": task.index, "ndeps": 0, "real": False,
                    "empty": True}
        watch = tracing.Stopwatch(self.device)
        inst_w = instances[task.index]
        with self.device_section(watch):
            proof = ly.prove_base_instance(ctype, inst_w, challenges, cap,
                                           self.source, self.device)
            watch.lap("prove")
        assert ly.verify_base_instance(
            ctype, inst_w, challenges, cap, proof, self.device), \
            "verify-after-prove failed"
        watch.lap("verify")
        self.stats[task.key()] = watch.done()
        return {"kind": task.kind, "real": True, "circuit_type": ctype,
                "proof": proof, "public_inputs": proof.public_inputs}

    def prove_fn(self, task: sch.ProofTask, deps):
        # leaf tasks carry the RECURSION-layer circuit type; eligibility is
        # decided by the BASE type they aggregate
        tower = self.tower
        if tower and task.kind == "leaf" and \
                self.eligible(task.payload.base_circuit_type):
            return self._prove_leaf(task, deps)
        if tower and task.kind == "node" and self.eligible(task.circuit_type):
            return self._prove_node(task, deps)
        if tower and task.kind == "scheduler" and any(
                deps[d.key()].get("real") for d in task.deps):
            return self._prove_scheduler(task, deps)
        real = (self.prove_mode == "full" or
                (self.prove_mode == "spot" and task.kind == "base"
                 and task.circuit_type in self.spot_types))
        if real and task.kind == "base":
            return self._prove_base(task)
        return {"kind": task.kind, "circuit_type": task.circuit_type,
                "index": task.index, "ndeps": len(deps), "real": False}

    # -- the per-type subtrees in processes of their own (`type_workers`) --

    def run_subtrees(self, pool) -> Dict:
        """Prove the base, leaf and node tasks of every type with real
        tower tasks in the processes of `pool` (`_subtree_worker_init`:
        each makes this flow's trace, artifacts and DAG once, then takes
        types off the queue, those with the most expected leaf work first,
        `_expected_leaf_work`) and take their records into this flow's
        source, their stats, and the IRs of their final leaves and nodes,
        rebuilt from their shapes: the scheduler task here then finds every
        dependency done. Returns the workers' kernel launches."""
        # a type whose final node the source already holds resumes here
        done = {t.circuit_type for t in self.dag[-1].deps
                if sch.stored_record(self.source, t) is not None}
        types = {_task_type(t) for t in self.dag
                 if t.kind in ("leaf", "node")
                 and self.eligible(_task_type(t))} - done
        work = {t: _expected_leaf_work(t, len(self.real_payloads[t][0]),
                                       self.geometry) for t in types}
        types = sorted(types, key=lambda t: (-work[t], t))
        launches: Dict[str, int] = {}
        for res in pool.imap_unordered(_subtree_worker_run, types):
            self._take_subtree(*res, launches)
        return launches

    def _take_subtree(self, t, records, padding, stats, shapes, counts,
                      launches):
        """A worker's subtree of type `t` (`_subtree_worker_run`'s result)
        into this flow, its launches added to `launches`."""
        for task, rec in records:
            sch.store_record(self.source, task, rec)
        if padding is not None:
            self.source.set_base_layer_padding_proof(padding, t)
        self.stats.update(stats)
        vks = {"leaf_final": next(r["vk"] for task, r in records
                                  if task.kind == "leaf"),
               "node_final": records[-1][1]["vk"]}
        for (kind, _t), shape in shapes.items():
            self.rigs[(kind, t)] = (
                bd.CircuitBuilder.ir_from_shape(shape), vks[kind])
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v


_WORKER: Dict = {}


def _subtree_worker_init(flow_args: Dict, engine_cfg, lock) -> None:
    """A `type_workers` process: its own flow of the same block, under the
    caller's engine config, sharing the caller's device lock."""
    _WORKER["engine_cfg"] = engine_cfg
    with ly.engine_override(engine_cfg):
        _WORKER["flow"] = _BlockFlow(**flow_args, source=None,
                                     device_lock=lock)


def _subtree_worker_run(base_t: int):
    """The base, leaf and node tasks of `base_t` in this process: their
    (task, record) pairs in DAG order, the type's padding proof record
    (None unless its leaves are ragged), their stats, the IR shapes of the
    type's final leaf and node, and the kernel launches they made."""
    flow = _WORKER["flow"]
    tasks = [t for t in flow.dag if t.kind in ("base", "leaf", "node")
             and _task_type(t) == base_t]
    before = dict(ck.LAUNCHES)
    with ly.engine_override(_WORKER["engine_cfg"]):
        done = sch.run_dag(tasks, flow.prove_fn, flow.source)
    counts = {k: ck.LAUNCHES[k] - before.get(k, 0) for k in ck.LAUNCHES}
    keys = {t.key() for t in tasks}
    shapes = {k: v for k, v in flow.ir_shapes.items() if k[1] == base_t}
    return (base_t, [(t, done[t.key()]) for t in tasks],
            flow.source.get_base_layer_padding_proof(base_t),
            {k: v for k, v in flow.stats.items() if k in keys}, shapes,
            counts)


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
              type_workers: int = 0,
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
    in-circuit verifier slot per blob.

    `type_workers=k > 1` (the port's own option, with `tower=True`) proves
    the base, leaf and node tasks of the types in k spawned processes on
    the same device (`_BlockFlow.run_subtrees`; each releases a type's
    leaf and node builders, layouts and setups and the base setups once
    the type's final node is proved), and the scheduler in this one from
    their records: the same proofs, with the host's synthesis of k
    circuits at a time, and `recursion_rigs` holding each type's final
    leaf and node as (ir, vk) only. `worker_launches` holds the kernel launches those processes
    made; every other launch is in this process's counts. The eip4844
    slots, already proven, stay in this process."""
    flow_args = dict(
        code=list(code), entry_address=entry_address, geometry=geometry,
        cycle_limit=cycle_limit, prove_mode=prove_mode,
        spot_types=tuple(spot_types), contracts=contracts, tower=tower,
        recursion_cfg=recursion_cfg, leaf_arity=leaf_arity,
        block_number=block_number, eip4844_outputs=tuple(eip4844_outputs),
        eip4844_slots=(), device=device)
    pool = None
    if tower and type_workers > 1:
        # the workers make their flows while this one makes its own
        ctx = multiprocessing.get_context("spawn")
        flow_args["device"] = gl.resolve_device(device)
        lock = ctx.Lock() if flow_args["device"].type == "cuda" else None
        pool = ctx.Pool(type_workers, initializer=_subtree_worker_init,
                        initargs=(flow_args, ly._ENGINE_OVERRIDE, lock))
    worker_launches: Dict[str, int] = {}
    try:
        flow = _BlockFlow(**dict(flow_args, eip4844_slots=eip4844_slots),
                          source=source)
        if pool is not None:
            worker_launches = flow.run_subtrees(pool)
            flow.lap("subtrees")
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    dag_results = sch.run_dag(flow.dag, flow.prove_fn, flow.source)
    flow.lap("dag_run")

    return BlockProvingResult(cycles=flow.cycles, artifacts=flow.artifacts,
                              circuit_makers=flow.makers,
                              dag_results=dag_results,
                              scheduler_witness=flow.sched_wit,
                              source=flow.source,
                              recursion_rigs=flow.rigs,
                              timings=flow.timings,
                              tower_stats=flow.stats,
                              worker_launches=worker_launches)
