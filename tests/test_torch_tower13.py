"""The whole block's recursion tower over the base types beyond 7, 8 and
10, and storage application's (10) tower at `leaf_arity=2`, held against
the JAX package (integers, tolerance 0), and the JAX verifier's judgement
of the card's production MainVM proof and production leaves of types 10
and 4.

The JAX side is the committed golden tower of the small whole block
(`golden.WHOLE_GOLDEN` at `testing_geometry()`, `TOWER_GOLDEN_CONFIG`,
`tools/gen_tower13_golden.py`): per type its base proofs, leaf, node and
the scheduler over all of them, with the leaf's gate, circuit and filled
witness digests. Per type the port's leaf over the same inner circuit has
the JAX package's gates and circuit, and filled from the golden base
proofs its witness and public inputs are the JAX package's. Synthesizing
the leaves of types 1, 5 and 13 at this geometry takes 3.5-10 s each on
a CPU, and filling those and the 60-column leaves of 3 and 6 up to some
30 s, so those cases are `slow`, as are the whole golden tower proved by
the port on the CPU (every proof byte-equal; tens of minutes of the plain
kernels) and the JAX verifier over the production MainVM proof (764 x
2^16, 50 queries) that `chip_smoke.py --out` wrote on the card.

Type 10's golden tower (`golden.TYPE10_GOLDEN`, `tools/gen_type10_golden.py`)
is that of the JAX package's `tests/test_type10_tower.py`: one storage
write, so a read and a write path at depth 4, one leaf of arity 2, its node
and the scheduler. The port's leaf over the depth-4 path circuit has the
JAX package's gates, circuit, witness and public inputs; the whole tower
proved by the port on the CPU is byte-equal (`slow`). The card's
production leaves of types 10 (2^22 x 48, two paths) and 4 (2^23 x 48),
written by `chip_smoke.py --out`, are judged by the JAX verifier over the
IR of their builder shape, made from the JAX builder's own pieces (`slow`).
"""

import dataclasses
import importlib
import json
import os

import pytest

from tests.test_torch_recursion import LIST_PATH_IRS
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import leaf_circuit as tlc
from zkevm_harness_tpu_torch.circuits.types import (RecursionLayerCircuitType,
                                                    leaf_for)
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import plonkish as tpk

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
TYPES = tuple(golden.TOWER13_GOLDEN_TYPES)
# synthesis at this geometry takes 3.5-10 s (arity 5 over the MainVM,
# thousands of hash-circuit columns);
# the fill of the 60-column leaves of 3 and 6 some 30 s of the plain
# kernels
SLOW_LEAVES = (1, 5, 13)
WIDE_FILLS = (3, 6)
CFG = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def summary():
    return _load("tower13_summary.json")


def test_golden_tower_covers_every_type_beyond_7_8_and_10(summary):
    assert sorted(TYPES) == sorted(set(range(1, 14)) - {7, 8, 10})
    assert summary["spot_types"] == list(TYPES)
    assert set(LIST_PATH_IRS) >= set(TYPES)
    real = {(k[0], k[1]) for k, kind, is_real in summary["records"]
            if is_real}
    for t in TYPES:
        assert ("base", t) in real and ("node", t) in real
        assert ("leaf", int(leaf_for(t))) in real
    assert ("scheduler", int(RecursionLayerCircuitType.SCHEDULER)) in real


@pytest.mark.parametrize("ctype", TYPES)
def test_golden_leaf_and_node_chain_the_recursion_queue(summary, ctype):
    """The golden leaf's public inputs are the base VK it verified, its
    queue head's capacity lanes and the type's recursion-queue tail; the
    node over that one leaf exposes the leaf's VK and the same interval."""
    want = summary["leaves"][str(ctype)]
    leaf = convert.proof_from_json(_load(f"tower13_leaf_{ctype}_proof.json"))
    pis = [int(v) for v in leaf.public_inputs]
    assert pis == want["base_vk"] + want["queue_head"][8:12] + \
        want["queue_tail"]
    assert want["queue_tail"] == \
        summary["makers"][str(ctype)]["queue"]["tail"]
    assert want["num_real"] == want["arity"] == len(
        _load(f"tower13_base_{ctype}_proofs.json"))
    node = convert.proof_from_json(_load(f"tower13_node_{ctype}_proof.json"))
    assert [int(v) for v in node.public_inputs] == \
        _load(f"tower13_leaf_{ctype}_vk.json") + pis


def test_golden_scheduler_public_inputs(summary):
    sched = convert.proof_from_json(_load("tower13_scheduler_proof.json"))
    assert [int(v) for v in sched.public_inputs] == summary["scheduler_pi"]


def _leaf(ctype, arity):
    """The port's leaf over the type's inner circuit at testing geometry,
    synthesized and finalized."""
    name, make = LIST_PATH_IRS[ctype]
    ir = make(importlib.import_module("zkevm_harness_tpu_torch.circuits."
                                      + name))
    b, lay = tlc.synthesize_leaf(ir, CFG, arity, ctype)
    return b, lay, b.finalize()


def _same_witness(ctype, want, b, lay):
    """Filled from the golden base proofs and queue head, the leaf's
    witness is the JAX package's (its digest) and its public inputs the
    golden leaf proof's."""
    chunk = [convert.proof_from_json(d)
             for d in _load(f"tower13_base_{ctype}_proofs.json")]
    W = b.fill_witness(tlc.leaf_assignments(
        lay, want["base_vk"], chunk, queue_head=want["queue_head"]),
        device="cpu")
    assert convert.field_values_sha256(W) == want["witness_sha256"]
    pis = tlc.leaf_public_inputs(lay, want["base_vk"], chunk,
                                 queue_head=want["queue_head"], device="cpu")
    leaf = convert.proof_from_json(_load(f"tower13_leaf_{ctype}_proof.json"))
    assert pis == [int(v) for v in leaf.public_inputs]


@pytest.mark.parametrize("ctype", [
    pytest.param(t, marks=pytest.mark.slow) if t in SLOW_LEAVES else t
    for t in TYPES])
def test_leaf_equal_to_jax(summary, ctype):
    """The port's leaf over the type's inner circuit at testing geometry
    has the JAX package's gates, permutations, public variables, shape,
    const columns and copy wiring (their digests), and its filled witness
    and public inputs are the JAX package's (`test_leaf_witness_of_the_
    wider_leaves` for the leaves of 3 and 6)."""
    want = summary["leaves"][str(ctype)]
    b, lay, built = _leaf(ctype, want["arity"])
    got = convert.builder_circuit_digests(b, built)
    assert got == {k: want[k] for k in got}
    if ctype not in WIDE_FILLS:
        _same_witness(ctype, want, b, lay)


@pytest.mark.slow
@pytest.mark.parametrize("ctype", WIDE_FILLS)
def test_leaf_witness_of_the_wider_leaves(summary, ctype):
    want = summary["leaves"][str(ctype)]
    b, lay, _built = _leaf(ctype, want["arity"])
    _same_witness(ctype, want, b, lay)


def test_leaf_ir_rebuilt_from_its_shape(summary):
    """`CircuitBuilder.ir_from_shape` (what a scheduler in another process
    than the leaf's and node's uses) makes the finalized builder's IR: the
    same fields and the same symbolic gate calls."""
    from tests.test_torch_recursion import _calls
    from zkevm_harness_tpu_torch.circuits import builder as bd
    name, make = LIST_PATH_IRS[2]
    ir = make(importlib.import_module("zkevm_harness_tpu_torch.circuits."
                                      + name))
    b, _lay = tlc.synthesize_leaf(ir, CFG, summary["leaves"]["2"]["arity"], 2)
    built = b.finalize()
    again = bd.CircuitBuilder.ir_from_shape(
        json.loads(json.dumps(b.ir_shape())))
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "gate_part_counts", "gate_part_degrees", "gate_part_cols",
                  "lookup_sets"):
        assert getattr(again, field) == getattr(built.ir, field), field
    assert _calls(again) == _calls(built.ir)


@pytest.mark.slow
def test_golden_tower13_on_the_cpu(summary):
    """The port's `harness.run_block(tower=True)` of the small whole block
    over the golden types, on the CPU's plain kernels: every base, leaf,
    node and scheduler VK and proof equals the JAX package's bytes, and the
    flow's summary equals the golden one."""
    from zkevm_harness_tpu_torch import harness
    from zkevm_harness_tpu_torch.circuits import scheduler_circuit as tsc
    from zkevm_harness_tpu_torch.prover import layers as tly
    from zkevm_harness_tpu_torch.prover import scheduler as tsch
    from zkevm_harness_tpu_torch.utils import serde
    from zkevm_harness_tpu_torch.vm import isa

    def as_json(proof):
        return convert.json_roundtrip(serde.proof_to_json(proof))

    with tly.engine_override(CFG):
        res = harness.run_block(
            golden.whole_block(isa, **golden.WHOLE_GOLDEN),
            prove_mode="spot", spot_types=TYPES,
            contracts=dict(golden.hash_callees(
                isa, golden.WHOLE_GOLDEN["callee_reps"])),
            tower=True, recursion_cfg=CFG, type_workers=3, device="cpu")
    src = res.source
    for t in TYPES:
        n = summary["leaves"][str(t)]["num_real"]
        assert [as_json(src.get_base_layer_proof(t, i)["proof"])
                for i in range(n)] == _load(f"tower13_base_{t}_proofs.json")
        for kind, rec in (("leaf", src.get_leaf_layer_proof(
                int(leaf_for(t)), 0)), ("node", src.get_node_layer_proof(
                    t, 0, 0))):
            assert [int(v) for v in rec["vk"]] == \
                _load(f"tower13_{kind}_{t}_vk.json")
            assert as_json(rec["proof"]) == \
                _load(f"tower13_{kind}_{t}_proof.json")
    srec = src.get_scheduler_proof()
    assert [int(v) for v in srec["vk"]] == _load("tower13_scheduler_vk.json")
    assert as_json(srec["proof"]) == _load("tower13_scheduler_proof.json")
    assert srec["scheduler_pi"] == summary["scheduler_pi"]
    dag = tsch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()})
    got = convert.json_roundtrip(convert.block_proving_summary(
        res, dag, tsc.scheduler_aux_values(res.scheduler_witness)))
    for part in ("cycles", "dag", "records", "makers", "scheduler_witness"):
        assert got[part] == summary[part], part


# -- the card's production MainVM proof under the JAX verifier -----------------

def test_cards_main_vm_proof_is_the_production_shape():
    s = _load("main_vm_production_summary.json")
    proof = convert.proof_from_json(_load("main_vm_production_proof.json"))
    assert s["shape"] == [16, 764] and s["cycles"] == 5585
    assert s["geometry"] == {"log_n": 16, "limb_bits": 16, "num_limbs": 16}
    assert s["config"] == golden.TOWER_CONFIG
    assert [int(v) for v in proof.public_inputs] == s["public_inputs"]
    assert len(proof.ood_witness) == 764
    assert len(proof.fri.query_positions) == 50
    assert len(_load("main_vm_production_vk.json")) == 16 * 4


@pytest.mark.slow
def test_jax_verifier_accepts_the_cards_main_vm_proof():
    """The 5585-cycle MainVM instance proved on the card at 764 x 2^16
    (`chip_smoke.py --out`, phase `main_vm`), judged by the JAX package's
    `prover/plonkish.verify` over the JAX package's own IR of that
    geometry: accepted, and refused with a public input or an OOD value
    changed."""
    from zkevm_harness_tpu.circuits import main_vm_circuit as jmvc
    from zkevm_harness_tpu.prover import layers as jly
    from zkevm_harness_tpu.prover import plonkish as jpk
    from zkevm_harness_tpu.utils import serde as jserde
    s = _load("main_vm_production_summary.json")
    geo = jly.main_vm_geometry_for_capacity(s["cycles"], limb_bits=16)
    assert dataclasses.asdict(geo) == s["geometry"]
    ir = jmvc.main_vm_ir(geo)
    cfg = jpk.PlonkishConfig(**s["config"])
    vk = _load("main_vm_production_vk.json")
    data = _load("main_vm_production_proof.json")
    proof = jserde.proof_from_json(data, jserde.default_registry())
    assert jpk.verify(ir, vk, proof, cfg)
    bad = jserde.proof_from_json(data, jserde.default_registry())
    bad.public_inputs[16] = (int(bad.public_inputs[16]) + 1) % P
    assert not jpk.verify(ir, vk, bad, cfg)
    bad = jserde.proof_from_json(data, jserde.default_registry())
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((int(c0) + 1) % P, c1)
    assert not jpk.verify(ir, vk, bad, cfg)


# -- storage application's tower at leaf_arity=2 ----------------------------

@pytest.fixture(scope="module")
def summary10():
    return _load("tower10_summary.json")


def test_type10_golden_is_the_jax_tests_tower(summary10):
    """One leaf of arity 2 over the read and write paths, a node over it,
    the scheduler over type 10's slot; the leaf's public inputs are the
    base VK, its queue head's capacity lanes and the queue's tail, the
    node's the leaf VK and those."""
    assert summary10["golden"] == golden.TYPE10_GOLDEN == dict(
        depth=golden.STORAGE_APP_DEPTH, leaf_arity=2)
    assert summary10["spot_types"] == [10]
    want = summary10["leaf"]
    assert want["num_real"] == want["arity"] == 2 == len(
        _load("tower10_base_proofs.json"))
    leaf = convert.proof_from_json(_load("tower10_leaf_proof.json"))
    pis = [int(v) for v in leaf.public_inputs]
    assert pis == want["base_vk"] + want["queue_head"][8:12] + \
        want["queue_tail"]
    assert want["queue_tail"] == summary10["makers"]["10"]["queue"]["tail"]
    node = convert.proof_from_json(_load("tower10_node_proof.json"))
    assert [int(v) for v in node.public_inputs] == \
        _load("tower10_leaf_vk.json") + pis
    sched = convert.proof_from_json(_load("tower10_scheduler_proof.json"))
    assert [int(v) for v in sched.public_inputs] == summary10["scheduler_pi"]


def test_type10_leaf_equal_to_jax(summary10):
    """The port's leaf of arity 2 over the depth-4 path circuit has the JAX
    package's gates, permutations, shape, const columns and wiring, and
    filled from the golden paths its witness and public inputs are the
    JAX package's."""
    want = summary10["leaf"]
    b, lay, built = _leaf(10, want["arity"])
    got = convert.builder_circuit_digests(b, built)
    assert got == {k: want[k] for k in got}
    chunk = [convert.proof_from_json(d)
             for d in _load("tower10_base_proofs.json")]
    W = b.fill_witness(tlc.leaf_assignments(
        lay, want["base_vk"], chunk, queue_head=want["queue_head"]),
        device="cpu")
    assert convert.field_values_sha256(W) == want["witness_sha256"]
    leaf = convert.proof_from_json(_load("tower10_leaf_proof.json"))
    assert tlc.leaf_public_inputs(lay, want["base_vk"], chunk,
                                  queue_head=want["queue_head"],
                                  device="cpu") == \
        [int(v) for v in leaf.public_inputs]


@pytest.mark.slow
def test_golden_type10_tower_on_the_cpu(summary10):
    """The port's `harness.run_block(tower=True, leaf_arity=2)` of the type-10
    block on the CPU's plain kernels: the two path proofs, the leaf, the
    node and the scheduler, VKs and proofs, equal the JAX package's bytes,
    and the flow's summary the golden one."""
    from zkevm_harness_tpu_torch import harness
    from zkevm_harness_tpu_torch.circuits import scheduler_circuit as tsc
    from zkevm_harness_tpu_torch.circuits.types import testing_geometry
    from zkevm_harness_tpu_torch.prover import layers as tly
    from zkevm_harness_tpu_torch.prover import scheduler as tsch
    from zkevm_harness_tpu_torch.utils import serde
    from zkevm_harness_tpu_torch.vm import isa

    def as_json(proof):
        return convert.json_roundtrip(serde.proof_to_json(proof))

    arity = golden.TYPE10_GOLDEN["leaf_arity"]
    geo = dataclasses.replace(testing_geometry(),
                              storage_tree_depth=golden.TYPE10_GOLDEN["depth"])
    with tly.engine_override(CFG):
        res = harness.run_block(golden.type10_block(isa), geometry=geo,
                                prove_mode="spot", spot_types=(10,),
                                tower=True, recursion_cfg=CFG,
                                leaf_arity=arity, device="cpu")
    src = res.source
    assert [as_json(src.get_base_layer_proof(10, i)["proof"])
            for i in range(2)] == _load("tower10_base_proofs.json")
    for kind, rec in (("leaf", src.get_leaf_layer_proof(int(leaf_for(10)),
                                                        0)),
                      ("node", src.get_node_layer_proof(10, 0, 0)),
                      ("scheduler", src.get_scheduler_proof())):
        assert [int(v) for v in rec["vk"]] == _load(f"tower10_{kind}_vk.json")
        assert as_json(rec["proof"]) == _load(f"tower10_{kind}_proof.json")
    assert src.get_scheduler_proof()["scheduler_pi"] == \
        summary10["scheduler_pi"]
    dag = tsch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()},
        leaf_arity=arity)
    got = convert.json_roundtrip(convert.block_proving_summary(
        res, dag, tsc.scheduler_aux_values(res.scheduler_witness)))
    for part in ("cycles", "dag", "records", "makers", "scheduler_witness"):
        assert got[part] == summary10[part], part


# -- the card's production leaves under the JAX verifier ---------------------

PRODUCTION_LEAVES = {10: (22, 2), 4: (23, 1)}  # log rows, arity


@pytest.mark.parametrize("ctype", sorted(PRODUCTION_LEAVES))
def test_cards_production_leaf_is_the_production_shape(ctype):
    s = _load(f"leaf{ctype}_production_summary.json")
    proof = convert.proof_from_json(_load(f"leaf{ctype}_production_proof.json"))
    log_n, arity = PRODUCTION_LEAVES[ctype]
    assert (s["type"], s["index"], s["arity"], s["num_real"]) == \
        (ctype, 0, arity, arity)
    assert s["leaf_arity"] == golden.TOWER_LEAF_ARITY
    assert s["config"] == golden.TOWER_CONFIG
    assert (s["shape"]["log_n"], s["shape"]["num_witness"]) == (log_n, 48)
    assert [int(v) for v in proof.public_inputs] == s["public_inputs"]
    assert len(s["public_inputs"]) == 16 * 4 + 4 + 12
    assert len(proof.ood_witness) == 48
    assert len(proof.fri.query_positions) == 50
    assert len(_load(f"leaf{ctype}_production_vk.json")) == 16 * 4


@pytest.mark.slow
@pytest.mark.parametrize("ctype", sorted(PRODUCTION_LEAVES))
def test_jax_verifier_accepts_the_cards_production_leaf(ctype):
    """The first production leaf of type 10 (two paths at depth 256) and of
    type 4 (the log demuxer) proved on the card (`chip_smoke.py --out`,
    phase `tower`), judged by the JAX package's `prover/plonkish.verify`
    over the IR of the leaf's builder shape, made by the JAX builder's own
    `_make_ir`: accepted, and refused with a public input or an OOD value
    changed."""
    from zkevm_harness_tpu.circuits import builder as jbd
    from zkevm_harness_tpu.prover import plonkish as jpk
    from zkevm_harness_tpu.utils import serde as jserde
    s = _load(f"leaf{ctype}_production_summary.json")
    shape = s["shape"]
    b = jbd.CircuitBuilder(slots=shape["slots"])
    b.tiles, b.p2_base = shape["tiles"], 3 * shape["slots"]
    ir = b._make_ir(shape["log_n"], shape["num_witness"], shape["num_const"],
                    tuple(tuple(c) for c in shape["public_input_cells"]),
                    shape["copy_chunk"])
    cfg = jpk.PlonkishConfig(**s["config"])
    vk = _load(f"leaf{ctype}_production_vk.json")
    data = _load(f"leaf{ctype}_production_proof.json")
    proof = jserde.proof_from_json(data, jserde.default_registry())
    assert jpk.verify(ir, vk, proof, cfg)
    bad = jserde.proof_from_json(data, jserde.default_registry())
    bad.public_inputs[0] = (int(bad.public_inputs[0]) + 1) % P
    assert not jpk.verify(ir, vk, bad, cfg)
    bad = jserde.proof_from_json(data, jserde.default_registry())
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((int(c0) + 1) % P, c1)
    assert not jpk.verify(ir, vk, bad, cfg)
