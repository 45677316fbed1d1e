"""The port's block proving flow (`harness.run_block`, `prover/scheduler.py`,
`witness/{postprocessing,closed_form,scheduler_witness}.py`,
`utils/data_source.py`) held against the JAX package bit for bit
(integers, tolerance 0).

Tier-1 runs the flow dry (every task a metadata record) and compares it
with the JSON summaries the JAX package wrote (`tools/gen_tower_golden.py`):
the proof DAG, every CircuitMaker's closed-form inputs and recursion-queue
tail, and the scheduler witness; a second run on the same data source
writes nothing. The JAX package's live dry run, the golden tower on the
CPU (byte-equal to `test_artifacts/tower_golden_*`, minutes of the plain
kernels) and the resume from a JAX data source are `slow`.
"""

import dataclasses
import json
import os

import pytest

from zkevm_harness_tpu_torch import convert, golden, harness
from zkevm_harness_tpu_torch.circuits import scheduler_circuit as tsc
from zkevm_harness_tpu_torch.circuits import types as ttypes
from zkevm_harness_tpu_torch.circuits.types import GeometryConfig
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover import scheduler as tsch
from zkevm_harness_tpu_torch.utils import serde
from zkevm_harness_tpu_torch.utils.data_source import (InMemoryDataSource,
                                                       LocalFileDataSource)
from zkevm_harness_tpu_torch.vm import isa as tisa

ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


class CountingSource(InMemoryDataSource):
    def __init__(self):
        super().__init__()
        self.writes = 0

    def set(self, value, *key):
        self.writes += 1
        super().set(value, *key)


def summary(res):
    dag = tsch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()})
    return convert.json_roundtrip(convert.block_proving_summary(
        res, dag, tsc.scheduler_aux_values(res.scheduler_witness)))


@pytest.fixture(scope="module")
def dry():
    src = CountingSource()
    res = harness.run_block(golden.harness_block(tisa), prove_mode="dry",
                            source=src, device="cpu")
    return res, src


@pytest.mark.parametrize("part", ["cycles", "dag", "records", "makers",
                                  "scheduler_witness"])
def test_dry_flow_equal_to_jax(dry, part):
    want = _load("harness_dry_summary.json")
    assert summary(dry[0])[part] == want[part]


def test_dry_flow_shape(dry):
    res, _ = dry
    assert res.cycles == len(golden.harness_block(tisa))
    assert res.source.get_scheduler_proof() is not None
    for t, cm in res.circuit_makers.items():
        assert len(cm.queue) == res.artifacts.per_circuit[t].num_instances
        if cm.instances:
            assert cm.first.closed_form_input.start_flag
            assert cm.last.closed_form_input.completion_flag
    assert set(res.timings) >= {"trace_s", "artifacts_s",
                                "circuit_makers_s", "dag_run_s"}


def test_dry_resume_writes_nothing(dry):
    res, src = dry
    before = src.writes
    res2 = harness.run_block(golden.harness_block(tisa), prove_mode="dry",
                             source=src, device="cpu")
    assert src.writes == before > 0
    assert res2.dag_results.keys() == res.dag_results.keys()


def test_tower_block_flow_equal_to_the_golden_towers():
    """The golden tower's block, run dry: its DAG, CircuitMakers and
    scheduler witness are those of the JAX package's tower run."""
    res = harness.run_block(golden.tower_block(tisa), device="cpu")
    got, want = summary(res), _load("tower_golden_summary.json")
    for part in ("cycles", "dag", "makers", "scheduler_witness"):
        assert got[part] == want[part], part


@pytest.fixture(scope="module")
def whole_golden_dry():
    """The small whole block (`golden.WHOLE_GOLDEN`, every base type, type
    1 with five instances) through the flow dry: its recursion queues and
    instance counts."""
    res = harness.run_block(
        golden.whole_block(tisa, **golden.WHOLE_GOLDEN), prove_mode="dry",
        contracts=dict(golden.hash_callees(
            tisa, golden.WHOLE_GOLDEN["callee_reps"])), device="cpu")
    return ({t: m.queue for t, m in res.circuit_makers.items()},
            {t: a.num_instances for t, a in res.artifacts.per_circuit.items()})


def _dag_rows(dag):
    """Each task's kind, type, depth, index, its deps' keys and its payload
    as plain ints and lists."""
    def plain(v):
        if isinstance(v, (list, tuple)) or hasattr(v, "tolist"):
            return [plain(x) for x in (v.tolist() if hasattr(v, "tolist")
                                       else v)]
        return int(v)

    rows = []
    for t in dag:
        pay = None
        if t.payload is not None:
            pay = {k: plain(v) for k, v in sorted(vars(t.payload).items())}
        rows.append((t.kind, int(t.circuit_type), t.depth, t.index,
                     [tuple(int(x) if not isinstance(x, str) else x
                            for x in d.key()) for d in t.deps], pay))
    return rows


@pytest.mark.parametrize("leaf_arity", [2, 1])
def test_block_dag_at_leaf_arity_equal_to_jax(whole_golden_dry, leaf_arity):
    """`build_block_dag(leaf_arity=...)` over the small whole block's
    recursion queues is the JAX package's, task for task: kinds, types,
    indices, deps, and each leaf's and node's payload (its base proofs,
    queue head and tail, items). Type 1's five instances make the ragged
    chunks [2, 2, 1] at arity 2 and five leaves at arity 1."""
    from zkevm_harness_tpu.prover import scheduler as jsch
    from zkevm_harness_tpu.witness import recursion as jrec
    queues, counts = whole_golden_dry
    jq = {t: jrec.RecursionQueueSimulator(q.encodings, head=q.head,
                                          width=q.width)
          for t, q in queues.items()}
    got = tsch.build_block_dag(queues, counts, leaf_arity=leaf_arity)
    want = jsch.build_block_dag(jq, counts, leaf_arity=leaf_arity)
    assert _dag_rows(got) == _dag_rows(want)
    chunks = [len(t.deps) for t in got
              if t.kind == "leaf" and t.payload.base_circuit_type == 1]
    assert chunks == ([2, 2, 1] if leaf_arity == 2 else [1] * 5)


def test_drop_setup_takes_out_that_setup_alone(monkeypatch):
    """`layers.drop_setup` (what a leaf does with its base setup) takes the
    cache's entries of that SetupData, alone or beside its program, and
    leaves every other entry."""
    def sd(tag):
        return tly.SetupData(ir=None, setup=None, vk=[tag], config=None)

    a, b = sd(1), sd(2)
    cache = {("base", 1): a, ("ff", 2): (b, "program"), ("base", 3): sd(3)}
    monkeypatch.setattr(tly, "_SETUP_CACHE", dict(cache))
    tly.drop_setup(a)
    assert set(tly._SETUP_CACHE) == {("ff", 2), ("base", 3)}
    tly.drop_setup(b)
    assert set(tly._SETUP_CACHE) == {("base", 3)}


def test_subtrees_go_out_by_expected_leaf_work():
    """`run_subtrees` hands out first the types with the most expected
    leaf work, base instances times their base circuit's columns: at the
    whole block's counts (type 10 18 paths, type 3 four instances) and
    production geometry storage application, then the log demuxer, whose
    9,894 columns are the widest."""
    geo = GeometryConfig()
    counts = {t: 1 for t in range(1, 14)}
    counts.update({10: 18, 3: 4})
    work = {t: harness._expected_leaf_work(t, n, geo)
            for t, n in counts.items()}
    order = sorted(counts, key=lambda t: -work[t])
    assert order[:2] == [10, 4]
    ir4 = tly.base_ir_for_type(4, geo)
    assert (ir4.log_n, ir4.num_witness) == (16, 9894)
    assert work[4] == ir4.num_witness + ir4.num_const
    assert work[10] == 18 * harness._expected_leaf_work(10, 1, geo)


@pytest.mark.parametrize("ctype", [8, 10])
def test_base_ir_for_type_is_the_setups_ir(ctype):
    """The IR made alone is the one of the type's setup, and the IR alone
    leaves the setup cache as it was (storage application at the depth of
    its path golden)."""
    geo = dataclasses.replace(ttypes.testing_geometry(),
                              storage_tree_depth=golden.STORAGE_APP_DEPTH)
    before = dict(tly._SETUP_CACHE)
    ir = tly.base_ir_for_type(ctype, geo)
    assert tly._SETUP_CACHE == before
    sd = tly.base_setup_for_type(ctype, geo, device="cpu")
    for field in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk",
                  "public_input_cells", "gate_part_counts"):
        assert getattr(ir, field) == getattr(sd.ir, field), field


def test_records_and_data_sources_through_json(tmp_path):
    proof = convert.proof_from_json(_load("tower_golden_leaf_proof.json"))
    rec = {"kind": "leaf", "real": True, "circuit_type": 8, "proof": proof,
           "vk": _load("tower_golden_leaf_vk.json"), "arity": 2,
           "public_inputs": list(proof.public_inputs)}
    back = convert.proof_from_json(convert.json_roundtrip(
        convert.proof_to_json(rec)))
    assert serde.proof_to_json(back["proof"]) == serde.proof_to_json(proof)
    assert {k: v for k, v in back.items() if k != "proof"} == \
        {k: v for k, v in rec.items() if k != "proof"}
    src = InMemoryDataSource()
    src.set_leaf_layer_proof(rec, 10, 0)
    src.set_base_layer_vk([1, 2, 3], 8)
    copy = convert.data_source_from(src)
    assert copy.get_base_layer_vk(8) == [1, 2, 3]
    assert convert.proof_to_json(copy.get_leaf_layer_proof(10, 0)) == \
        convert.proof_to_json(rec)
    files = LocalFileDataSource(str(tmp_path))
    files.set_leaf_layer_proof(convert.proof_to_json(rec), 10, 0)
    assert convert.proof_from_json(files.get_leaf_layer_proof(10, 0))[
        "vk"] == rec["vk"]


@pytest.mark.slow
def test_dry_flow_equal_to_jax_live():
    """The JAX package's dry run of the same block, here (its summary is
    the committed one); then the port resumes from the JAX data source,
    converted, and writes nothing."""
    from zkevm_harness_tpu import harness as jharness
    from zkevm_harness_tpu.circuits import scheduler_circuit as jsc
    from zkevm_harness_tpu.prover import scheduler as jsch
    from zkevm_harness_tpu.vm import isa as jisa
    jres = jharness.run_block(golden.harness_block(jisa), prove_mode="dry")
    jdag = jsch.build_block_dag(
        {t: m.queue for t, m in jres.circuit_makers.items()},
        {t: a.num_instances for t, a in jres.artifacts.per_circuit.items()})
    want = convert.json_roundtrip(convert.block_proving_summary(
        jres, jdag, jsc.scheduler_aux_values(jres.scheduler_witness)))
    res = harness.run_block(golden.harness_block(tisa), prove_mode="dry",
                            device="cpu")
    assert summary(res) == want
    src = CountingSource()
    for key, value in convert.data_source_from(jres.source)._store.items():
        InMemoryDataSource.set(src, value, *key)
    harness.run_block(golden.harness_block(tisa), prove_mode="dry",
                      source=src, device="cpu")
    assert src.writes == 0


@pytest.mark.slow
def test_golden_tower_on_the_cpu():
    """`run_block(tower=True)` of the golden tower's block at its config:
    the leaf, node and scheduler VKs and proofs equal the JAX package's
    bytes; a second run on the same source writes nothing."""
    cfg = tpk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    src = CountingSource()
    with tly.engine_override(cfg):
        res = harness.run_block(golden.tower_block(tisa), prove_mode="spot",
                                spot_types=(8,), tower=True,
                                recursion_cfg=cfg, source=src, device="cpu")
    recs = {"leaf": src.get_leaf_layer_proof(10, 0),
            "node": src.get_node_layer_proof(8, 0, 0),
            "scheduler": src.get_scheduler_proof()}
    for name, rec in recs.items():
        assert rec["real"]
        assert [int(v) for v in rec["vk"]] == \
            _load(f"tower_golden_{name}_vk.json")
        assert convert.json_roundtrip(serde.proof_to_json(rec["proof"])) == \
            _load(f"tower_golden_{name}_proof.json")
    assert recs["scheduler"]["types"] == [8]
    assert [int(v) for v in recs["leaf"]["proof"].public_inputs[-12:]] == \
        [int(v) for v in res.artifacts.recursion_queues[8].tail]
    before = src.writes
    with tly.engine_override(cfg):
        harness.run_block(golden.tower_block(tisa), prove_mode="spot",
                          spot_types=(8,), tower=True, recursion_cfg=cfg,
                          source=src, device="cpu")
    assert src.writes == before


class _Pool:
    """A stand-in for the spawned pool of `run_subtrees`: the jobs in the
    order they are handed out, run here."""

    def __init__(self):
        self.jobs = []

    def imap_unordered(self, fn, items):
        for item in items:
            self.jobs.append(item)
            yield fn(item)


def test_run_subtrees_hands_out_every_type_once(monkeypatch):
    """`run_subtrees` hands the workers every type with tower tasks once,
    the most expected leaf work first (type 10's 18 paths, then the log
    demuxer), and takes each result in; a type whose final node the
    source already holds is not handed out."""
    counts = {t: 1 for t in range(1, 14)}
    counts.update({10: 18, 3: 4})
    flow = object.__new__(harness._BlockFlow)
    nodes = [tsch.ProofTask("node", t, 0) for t in counts]
    flow.dag = nodes + [tsch.ProofTask("scheduler", 0, 0, deps=tuple(nodes))]
    flow.source = InMemoryDataSource()
    flow.source.set_node_layer_proof({"real": True}, 7, 0, 0)
    flow.prove_mode, flow.spot_types = "full", ()
    flow.geometry = GeometryConfig()
    flow.real_payloads = {t: ([None] * n, None, 0) for t, n in counts.items()}
    taken = []
    monkeypatch.setattr(harness, "_subtree_worker_run", lambda t: (t,))
    monkeypatch.setattr(flow, "_take_subtree",
                        lambda t, launches: taken.append(t))
    pool = _Pool()
    assert flow.run_subtrees(pool) == {}
    assert taken == pool.jobs and sorted(taken) == sorted(set(counts) - {7})
    assert pool.jobs[:2] == [10, 4]
