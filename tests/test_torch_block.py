"""The port's block-level pipeline — `create_artifacts_from_tracer` and
`BlockArtifacts` (`witness/oracle.py`), the recursion queues and builders
(`witness/recursion.py`), the callstack sponge (`witness/callstack_sim.py`),
the MainVM instance split (`witness/vm_instance.py`) and the typed surface
of `prover/layers.py` — on the small whole block (`golden.WHOLE_GOLDEN`:
one round of every kind of traffic and one ecrecover call, all 13 base
types), held against the JAX package bit for bit (tolerance 0).

Tier-1 compares the port's artifacts with the JSON summary the JAX package
wrote (`tools/gen_block_golden.py`) and runs host Python of both packages;
the live JAX run of `create_artifacts_from_tracer` (whose queue simulators
XLA compiles for tens of seconds) is `slow`.
"""

import dataclasses
import json
import os

import pytest

from zkevm_harness_tpu.circuits.types import testing_geometry as jgeometry
from zkevm_harness_tpu.prover import layers as jly
from zkevm_harness_tpu.vm import isa as jisa
from zkevm_harness_tpu.vm.environment import (DefaultPrecompilesProcessor,
                                              InMemoryEventSink,
                                              InMemoryStorage,
                                              SimpleDecommitter, SimpleMemory)
from zkevm_harness_tpu.vm.interpreter import deploy_contract as jdeploy
from zkevm_harness_tpu.vm.interpreter import run_vm as jrun_vm
from zkevm_harness_tpu.vm.state import (BlockProperties, ProvingToolset,
                                        create_vm)
from zkevm_harness_tpu.witness import oracle as joracle
from zkevm_harness_tpu.witness import vm_instance as jvmi
from zkevm_harness_tpu.witness.tracer import WitnessTracer as JTracer
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits.types import (BaseLayerCircuitType,
                                                    GeometryConfig)
from zkevm_harness_tpu_torch.circuits.types import \
    testing_geometry as tgeometry
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.witness import callstack_sim as tcs
from zkevm_harness_tpu_torch.witness import oracle as toracle
from zkevm_harness_tpu_torch.witness import recursion as trec
from zkevm_harness_tpu_torch.witness import vm_instance as tvmi

ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def jax_trace_whole_block(rounds, call_every, callee_reps, ecrecover_calls):
    """(tracer, pre-state) of the whole block run by the JAX package's VM,
    its callees deployed by the JAX package's `deploy_contract`."""
    prog = golden.whole_block(jisa, rounds, call_every, callee_reps,
                              ecrecover_calls)
    limit = 8 * len(prog) + 64
    tracer = JTracer(limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=jgeometry())
    for address, code in golden.hash_callees(jisa, callee_reps):
        jdeploy(tools, address, code)
    pre_state = dict(tools.storage.inner)
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    jrun_vm(vm, prog, limit)
    assert vm.finished
    return tracer, pre_state


@pytest.fixture(scope="module")
def block():
    tracer, pre = golden.trace_whole_block(**golden.WHOLE_GOLDEN)
    art = toracle.create_artifacts_from_tracer(
        tracer, tgeometry(), initial_storage=pre, device="cpu")
    return tracer, pre, art


@pytest.fixture(scope="module")
def summary(block):
    tracer, _pre, art = block
    out = convert.block_artifacts_summary(
        art, tgeometry(), tly.real_base_instance_public_inputs)
    out["cycles"] = tracer.cycle_counter
    return out


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(ART, "whole_block_golden.json")) as f:
        return json.load(f)


def test_whole_block_traces_alike_in_both_packages(block):
    tracer, pre, _art = block
    jtracer, jpre = jax_trace_whole_block(**golden.WHOLE_GOLDEN)
    assert convert.tracer_queries(tracer) == convert.tracer_queries(jtracer)
    assert pre == jpre
    ec_calls = [d for (_, q, d, _r) in tracer.precompile_calls
                if q.address == golden.ECRECOVER_ADDRESS]
    assert ec_calls == golden.ecrecover_inputs(
        golden.WHOLE_GOLDEN["ecrecover_calls"])


SECTIONS = ("log_queue", "memory_queue", "sorted_memory_queue", "demuxed",
            "deduplicated", "per_circuit", "recursion_queues", "callstack",
            "storage_application", "ecrecover", "cycles")


@pytest.mark.parametrize("section", SECTIONS)
def test_artifacts_equal_the_jax_summary(summary, want, section):
    """Queue lengths and tails, the demuxed and deduplicated streams, the
    instance counts and recursion queues, the callstack sponge witness, the
    storage roots and paths, the ecrecover invocations."""
    assert summary[section] == want[section]


@pytest.mark.parametrize("ctype", range(1, 14))
def test_each_type_equals_the_jax_summary(summary, want, ctype):
    """Per base type: the decomposer's instance count, its binding
    challenges, and every instance's expected public inputs."""
    got, exp = summary["types"][str(ctype)], want["types"][str(ctype)]
    assert got["instances"] >= 1
    assert got == exp


def test_block_payloads_cover_every_type(block):
    _tracer, _pre, art = block
    pay = toracle.block_payloads(art, tgeometry())
    assert sorted(pay) == list(range(1, 14))
    assert all(len(insts) >= 1 for insts, _c, _cap in pay.values())
    assert len(pay[10][0]) == 2 * len(art.storage_application.instances)


def test_split_into_vm_instances_equal(block):
    tracer, _pre, _art = block
    jtracer, _ = jax_trace_whole_block(**golden.WHOLE_GOLDEN)
    got = [dataclasses.asdict(w) for w in
           tvmi.split_into_vm_instances(tracer)]
    exp = [dataclasses.asdict(w) for w in
           jvmi.split_into_vm_instances(jtracer)]
    assert got == exp and len(got) >= 1


def test_callstack_sponge_returns_to_its_seed(block):
    _tracer, _pre, art = block
    cw = art.callstack_witness
    assert cw.final_state == (0,) * 12 and cw.max_depth >= 1
    assert [o.is_push for o in cw.ops].count(True) == \
        [o.is_push for o in cw.ops].count(False)
    sim = tcs.FullWidthStackSimulator(device="cpu")
    sim.push(0, list(range(32)))
    sim._saved[-1] = ((1,) * 12, sim._saved[-1][1])
    with pytest.raises(AssertionError):
        sim.pop(1)


def test_recursion_builders(block):
    _tracer, _pre, art = block
    q = trec.RecursionQueueSimulator(device="cpu")
    for i in range(70):
        q.push_request(trec.RecursionRequest(5, (i, 1, 2, 3)))
    leaves = trec.create_leaf_witnesses(5, q)
    assert [t.num_items for t in leaves] == [32, 32, 6]
    assert leaves[1].queue_head == tuple(q.tails()[32])
    assert leaves[-1].queue_tail == q.tail
    levels = trec.aggregate_to_single_node(5, leaves)
    assert len(levels) == 1 and levels[0][0].num_items == 70
    vk = [1, 2, 3, 4] * 4
    com = trec.commit_vk(vk, device="cpu")
    params = trec.compute_leaf_params({3: vk, 1: vk[:8]}, device="cpu")
    assert [t for t, _ in params] == [1, 3] and params[1][1] == com
    assert len(trec.compute_leaf_vks_and_params_commitment(
        params, device="cpu")) == 4


def test_typed_surface_equals_jax():
    assert tly.REAL_BASE_CIRCUITS == jly.REAL_BASE_CIRCUITS == set(range(1, 14))
    assert tly.BASE_REGISTRY == {} and jly.BASE_REGISTRY == {}
    with pytest.raises(KeyError):
        tly.create_base_layer_setup_data(1, device="cpu")
    with pytest.raises(KeyError):
        tly.real_base_instance_public_inputs(14, None, None, 1)
    with pytest.raises(KeyError):
        tly.prove_base_instance(14, None, None, 1, device="cpu")
    assert len(BaseLayerCircuitType) == 13


@pytest.mark.parametrize("ctype", range(1, 14))
def test_base_dispatch_reaches_each_types_own_circuit(block, monkeypatch,
                                                      ctype):
    """`base_setup_for_type`, `prove_base_instance` and
    `verify_base_instance` reach type `ctype`'s own setup (its circuit
    type, the same setup for all three), and its prove and verify check
    the public inputs `real_base_instance_public_inputs` gives. Setups and
    proofs are stubbed: nothing is built or proved."""
    P = tly.gl.P
    reached = []

    def stub_setup(key, make_ir, make_setup, circuit_type, source, device,
                   psc=None):
        reached.append(int(circuit_type))
        return key

    def canon(vals):
        return [int(v) % P for v in vals]

    monkeypatch.setattr(tly, "_cached_setup", stub_setup)
    monkeypatch.setattr(tly, "_prove_checked",
                        lambda sd, witness, expected, circuit, device:
                        (sd, canon(expected)))
    monkeypatch.setattr(tly, "_verify_checked",
                        lambda sd, expected, proof, vk, device:
                        proof == (sd, canon(expected)))
    _tracer, _pre, art = block
    insts, ch, cap = toracle.block_payloads(art, tgeometry())[ctype]
    key = tly.base_setup_for_type(ctype, tgeometry(), device="cpu")
    proof = tly.prove_base_instance(ctype, insts[0], ch, cap, device="cpu")
    assert proof == (key, canon(tly.real_base_instance_public_inputs(
        ctype, insts[0], ch, cap)))
    assert tly.verify_base_instance(ctype, insts[0], ch, cap, proof,
                                    device="cpu")
    assert reached == [ctype] * 3


def test_whole_block_fills_every_type_at_production_geometry():
    """The whole block at `golden.WHOLE_BLOCK` as `chip_smoke.py` proves
    it: at `GeometryConfig()` every base type has an instance, type 7 a
    full one (its 7 calls)."""
    tracer, pre = golden.trace_whole_block(**golden.WHOLE_BLOCK)
    calls = [d for (_, q, d, _r) in tracer.precompile_calls]
    assert tracer.cycle_counter == 880 and len(calls) == 135
    ec_calls = [d for (_, q, d, _r) in tracer.precompile_calls
                if q.address == golden.ECRECOVER_ADDRESS]
    from zkevm_harness_tpu_torch.witness.ecrecover_witness import \
        ecrecover_decompose
    g = GeometryConfig()
    insts = ecrecover_decompose(ec_calls, g.cycles_per_ecrecover_circuit)
    assert len(insts) == 1 and len(insts[0].invocations) == 7
    assert all(inv.success for inv in insts[0].invocations)


@pytest.mark.slow
def test_live_jax_artifacts_equal(summary):
    """The JAX package's `create_artifacts_from_tracer` run here on the
    same block gives the same summary as the port's."""
    jtracer, jpre = jax_trace_whole_block(**golden.WHOLE_GOLDEN)
    art = joracle.create_artifacts_from_tracer(jtracer, jgeometry(),
                                               initial_storage=jpre)
    got = convert.block_artifacts_summary(
        art, jgeometry(), jly.real_base_instance_public_inputs)
    got["cycles"] = jtracer.cycle_counter
    assert got == summary


@pytest.mark.slow
def test_recursion_builders_and_vk_commitments_equal_jax():
    from zkevm_harness_tpu.witness import recursion as jrec
    tq = trec.RecursionQueueSimulator(device="cpu")
    jq = jrec.RecursionQueueSimulator()
    for i in range(40):
        req = (7, (i, i + 1, 2, 3))
        tq.push_request(trec.RecursionRequest(*req))
        jq.push_request(jrec.RecursionRequest(*req))
    assert tq.tail == jq.tail
    for t, j in zip(trec.create_leaf_witnesses(7, tq),
                    jrec.create_leaf_witnesses(7, jq)):
        assert (t.circuit_type, t.index, t.queue_head, t.queue_tail,
                t.num_items, t.proof_indices) == \
            (j.circuit_type, j.index, tuple(int(v) for v in j.queue_head),
             tuple(int(v) for v in j.queue_tail), j.num_items,
             j.proof_indices)
    vk = list(range(1, 40))
    assert trec.commit_vk(vk, device="cpu") == jrec.commit_vk(vk)
