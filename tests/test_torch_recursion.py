"""The port's recursion circuits (`circuits/verifier_circuit.py`,
`leaf_circuit.py`, `node_circuit.py`, `scheduler_circuit.py`,
`queue_circuit.py`) and the recursion surface of `prover/layers.py`, held
against the JAX package bit for bit (integers, tolerance 0).

The children are committed golden proofs, so no JAX proof or setup runs:
the golden flagship proof (no lookups) and the toy ecrecover proof (70
lookup sets) under the in-circuit verifier and a leaf of arity 2 (padded
and not); the golden tower's leaf and node proofs
(`tools/gen_tower_golden.py`) under a node and the two-type-capable
scheduler. For each: the synthesized gates, the witness assignments of the
child proof, the filled witness and the public inputs equal the JAX
package's; the witness satisfies the circuit and a tampered child does not.
The inner IRs' per-constraint list path (what the verifier replays
symbolically) makes the JAX package's algebra calls in its order.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from zkevm_harness_tpu.circuits import ecrecover_circuit as jec
from zkevm_harness_tpu.circuits import ffarith as jff
from zkevm_harness_tpu.circuits import flagship as jfl
from zkevm_harness_tpu.circuits import leaf_circuit as jlc
from zkevm_harness_tpu.circuits import node_circuit as jnc
from zkevm_harness_tpu.circuits import queue_circuit as jqc
from zkevm_harness_tpu.circuits import ram_permutation_circuit as jrc
from zkevm_harness_tpu.circuits import scheduler_circuit as jsc
from zkevm_harness_tpu.circuits import verifier_circuit as jvc
from zkevm_harness_tpu.prover import plonkish as jpk
from zkevm_harness_tpu.utils import serde as jserde
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import ecrecover_circuit as tec
from zkevm_harness_tpu_torch.circuits import ffarith as tff
from zkevm_harness_tpu_torch.circuits import flagship as tfl
from zkevm_harness_tpu_torch.circuits import leaf_circuit as tlc
from zkevm_harness_tpu_torch.circuits import node_circuit as tnc
from zkevm_harness_tpu_torch.circuits import queue_circuit as tqc
from zkevm_harness_tpu_torch.circuits import scheduler_circuit as tsc
from zkevm_harness_tpu_torch.circuits import verifier_circuit as tvc
from zkevm_harness_tpu_torch.circuits.types import base_capacity
from zkevm_harness_tpu_torch.circuits.types import \
    testing_geometry as small_geometry
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover import satisfy
from zkevm_harness_tpu_torch.witness.recursion import create_leaf_witnesses
from zkevm_harness_tpu_torch.witness.queues import FullWidthQueueSimulator

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
FLAGSHIP_CFG = dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8)
TOWER_CFG = golden.TOWER_GOLDEN_CONFIG


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _proofs(name):
    """(JAX proof, port proof) of a committed proof JSON."""
    d = _load(name)
    return (jserde.proof_from_json(d, jserde.default_registry()),
            convert.proof_from_json(d))


def same_builders(jb, tb):
    jq, jw = convert.builder_gates(jb)
    tq, tw = convert.builder_gates(tb)
    assert np.array_equal(jq, tq) and np.array_equal(jw, tw)
    assert tb.perms == jb.perms and tb.pi_vars == jb.pi_vars


def same_assignments(ja, ta):
    assert {int(k): int(v) for k, v in ja.items()} == ta


def same_witness(jb, tb, asg):
    jW = jb.fill_witness(asg)
    tW = tb.fill_witness(asg, device="cpu")
    assert np.array_equal(convert.pairs_to_u64(jW.lo, jW.hi),
                          tgl.to_u64(tW))
    return tW


def violations(built, W, pis):
    return satisfy.check_satisfied(
        built.ir, tgl.to_u64(W).astype(object),
        built.const_cols.astype(object), built.wiring, pis)


def failing_gates(b, asg):
    """How many arithmetic gates the values of `asg` leave unsatisfied."""
    return len(b.unsatisfied_gates(b.eval_values(asg, device="cpu"),
                                   device="cpu"))


def bump_first_pi(proof):
    return dataclasses.replace(
        proof, public_inputs=[(int(proof.public_inputs[0]) + 1) % P]
        + list(proof.public_inputs[1:]))


# -- the verifier over a proof without lookups --------------------------------

@pytest.fixture(scope="module")
def flagship():
    jp, tp = _proofs("flagship_log6_proof.json")
    vk = _load("flagship_log6_vk.json")
    jir = jfl.flagship_ir(log_n=6, width=8)
    tir = tfl.flagship_ir(log_n=6, width=8)
    return dict(jp=jp, tp=tp, vk=vk, jir=jir, tir=tir,
                jcfg=jpk.PlonkishConfig(**FLAGSHIP_CFG),
                tcfg=tpk.PlonkishConfig(**FLAGSHIP_CFG))


def test_inner_shape_equal(flagship):
    f = flagship
    assert dataclasses.asdict(tvc.inner_shape(f["tir"], f["tcfg"])) == \
        dataclasses.asdict(jvc.inner_shape(f["jir"], f["jcfg"]))


def test_verifier_equal_to_jax_and_satisfied(flagship):
    f = flagship
    jb, jlay = jvc.synthesize_verifier(f["jir"], f["jcfg"])
    tb, tlay = tvc.synthesize_verifier(f["tir"], f["tcfg"])
    same_builders(jb, tb)
    ja = jvc.verifier_assignments(jlay, f["vk"], f["jp"])
    ta = tvc.verifier_assignments(tlay, f["vk"], f["tp"])
    same_assignments(ja, ta)
    jbuilt, tbuilt = jb.finalize(), tb.finalize()
    assert tbuilt.ir.public_input_cells == jbuilt.ir.public_input_cells
    W = same_witness(jb, tb, ta)
    pis = tvc.verifier_public_inputs(f["vk"], f["tp"])
    assert pis == [int(v) for v in
                   jvc.verifier_public_inputs(f["vk"], f["jp"])]
    assert tb.public_values(ta, device="cpu") == pis
    assert violations(tbuilt, W, pis) == []
    # a tampered OOD value: the in-circuit OOD identity fails
    bad = dataclasses.replace(f["tp"], ood_witness=list(f["tp"].ood_witness))
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((c0 + 1) % P, c1)
    bad_asg = tvc.verifier_assignments(tlay, f["vk"], bad)
    assert violations(tbuilt, tb.fill_witness(bad_asg, device="cpu"), pis)
    assert failing_gates(tb, bad_asg) > 0


# -- the verifier over a proof with lookups (logup path) ---------------------

def test_verifier_over_lookups_equal_to_jax():
    curve = golden.ecrecover_toy_curve()
    jl = jec.build_ecrecover_program(jec.CurveParams(**curve)).layout
    tl = tec.build_ecrecover_program(tec.CurveParams(**curve)).layout
    jir = dataclasses.replace(jff.ff_ir(jl.params, jl.log_n, jl.num_rows,
                                        bind_c=jl.bind_c),
                              public_input_cells=jl.pi_cells)
    tir = tff.layout_ir(tl)
    assert len(tir.lookup_sets) == 70
    cfg = golden.MAIN_VM_CONFIG
    jb, jlay = jvc.synthesize_verifier(jir, jpk.PlonkishConfig(**cfg))
    tb, tlay = tvc.synthesize_verifier(tir, tpk.PlonkishConfig(**cfg))
    same_builders(jb, tb)
    jp, tp = _proofs("ecrecover_toy_proof.json")
    vk = _load("ecrecover_toy_vk.json")
    ta = tvc.verifier_assignments(tlay, vk, tp)
    same_assignments(jvc.verifier_assignments(jlay, vk, jp), ta)
    tb.finalize()
    assert failing_gates(tb, ta) == 0
    bad = dataclasses.replace(tp, ood_stage3=list(tp.ood_stage3))
    c0, c1 = bad.ood_stage3[0]
    bad.ood_stage3[0] = (c0, (c1 + 1) % P)
    assert failing_gates(tb, tvc.verifier_assignments(tlay, vk, bad)) > 0


# -- the inner IRs' list path ---------------------------------------------------

class _CallLog:
    """An algebra that records every call: the sequence a symbolic replay
    of the gates (the in-circuit verifier) turns into builder slots."""

    def __init__(self):
        self.log = []

    def _op(self, *call):
        self.log.append(call)
        return ("v", len(self.log))

    def add(self, a, b):
        return self._op("add", a, b)

    def sub(self, a, b):
        return self._op("sub", a, b)

    def mul(self, a, b):
        return self._op("mul", a, b)

    def mul_int(self, a, c):
        return self._op("mul_int", a, int(c) % P)

    def add_int(self, a, c):
        return self._op("add_int", a, int(c) % P)


def _calls(ir):
    alg = _CallLog()
    w = [("w", i) for i in range(ir.num_witness)]
    wn = [("wn", i) for i in range(ir.num_witness)]
    c = [("c", i) for i in range(ir.num_const)]
    out = ir.eval_gates(alg, w, wn, c)
    return alg.log, out


def _geo(ctype):
    return base_capacity(small_geometry(), ctype)


# (circuit module, IR of either package's module) for the inner types whose
# list path the in-circuit verifier replays like the JAX package's
LIST_PATH_IRS = {
    1: ("main_vm_circuit", lambda m: m.main_vm_ir(m.VmGeometry(
        **dataclasses.asdict(tly.main_vm_geometry_for_capacity(_geo(1)))))),
    2: ("decommitts_sorter_circuit", lambda m: m.decommitts_ir(
        *dataclasses.astuple(tly.decommitts_geometry_for_capacity(_geo(2))))),
    4: ("log_demux_circuit", lambda m: m.demux_ir(
        *dataclasses.astuple(tly.demux_geometry_for_capacity(_geo(4))))),
    8: ("ram_permutation_circuit", lambda m: m.ram_ir(
        *dataclasses.astuple(tly.ram_geometry_for_capacity(_geo(8))))),
    9: ("storage_sorter_circuit", lambda m: m.storage_ir(
        *dataclasses.astuple(tly.storage_geometry_for_capacity(_geo(9))))),
    10: ("storage_application_circuit",
         lambda m: m.path_ir(m.PathGeometry(depth=4))),
    11: ("events_sorter_circuit", lambda m: m.events_ir(
        *dataclasses.astuple(tly.events_geometry_for_capacity(_geo(11))))),
    12: ("events_sorter_circuit", lambda m: m.events_ir(
        *dataclasses.astuple(tly.events_geometry_for_capacity(_geo(12))))),
    3: ("decommitter_circuit", lambda m: m.decommitter_ir(
        tly.code_decommitter_geometry_for_capacity(_geo(3)).log_n)),
    5: ("keccak_circuit", lambda m: m.keccak_ir(
        tly.keccak_geometry_for_capacity(_geo(5)).log_n)),
    6: ("sha256_circuit", lambda m: m.sha256_ir(
        tly.sha256_geometry_for_capacity(_geo(6)).log_n)),
    13: ("linear_hasher_circuit", lambda m: m.hasher_ir(
        tly.hasher_geometry_for_capacity(_geo(13)).log_n)),
}


@pytest.mark.parametrize("ctype", sorted(LIST_PATH_IRS))
def test_inner_ir_list_path_calls_equal_to_jax(ctype):
    name, make = LIST_PATH_IRS[ctype]
    jm = importlib.import_module("zkevm_harness_tpu.circuits." + name)
    tm = importlib.import_module("zkevm_harness_tpu_torch.circuits." + name)
    jlog, jout = _calls(make(jm))
    tlog, tout = _calls(make(tm))
    assert len(tout) == len(jout) and len(tlog) > 500
    assert tlog == jlog


# -- leaf, node and scheduler ---------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_leaf_equal_to_jax_and_satisfied(flagship, padded):
    f = flagship
    head = tuple(int(v) for v in np.random.default_rng(5).integers(
        0, P, size=12, dtype=np.uint64))
    jb, jlay = jlc.synthesize_leaf(f["jir"], f["jcfg"], 2, 8, padded=padded)
    tb, tlay = tlc.synthesize_leaf(f["tir"], f["tcfg"], 2, 8, padded=padded)
    same_builders(jb, tb)
    real = 1 if padded else 2  # a padded leaf: one real proof, one padding
    ja = jlc.leaf_assignments(jlay, f["vk"], [f["jp"]] * real,
                              queue_head=head)
    ta = tlc.leaf_assignments(tlay, f["vk"], [f["tp"]] * real,
                              queue_head=head)
    same_assignments(ja, ta)
    tbuilt = tb.finalize()
    jb.finalize()
    W = same_witness(jb, tb, ta)
    pis = tlc.leaf_public_inputs(tlay, f["vk"], [f["tp"]] * real,
                                 queue_head=head, device="cpu")
    assert pis == [int(v) for v in jb.public_values(ja)]
    assert tuple(pis[-12:]) == tlc.advance_queue_head(
        head, 8, [f["tp"]] * real, device="cpu")
    assert violations(tbuilt, W, pis) == []
    bad = tlc.leaf_assignments(tlay, f["vk"],
                               [bump_first_pi(f["tp"])] * real,
                               queue_head=head)
    assert failing_gates(tb, bad) > 0


@pytest.fixture(scope="module")
def tower():
    """The golden tower's leaf rig (RAM permutation at testing geometry,
    arity 2) in both packages, and its committed proofs."""
    cfg = tpk.PlonkishConfig(**TOWER_CFG)
    jcfg = jpk.PlonkishConfig(**TOWER_CFG)
    geo = tly.ram_geometry_for_capacity(_geo(8))
    jir = jrc.ram_ir(geo.log_n, geo.tiles_per_queue)
    with tly.engine_override(cfg):
        sd = tly.base_setup_for_type(8, small_geometry(), device="cpu")
    # the block's two RAM-permutation instances: one leaf of arity 2
    jlb, _ = jlc.synthesize_leaf(jir, jcfg, 2, 8)
    tlb, _ = tlc.synthesize_leaf(sd.ir, cfg, 2, 8)
    same_builders(jlb, tlb)
    summary = _load("tower_golden_summary.json")
    out = dict(cfg=cfg, jcfg=jcfg, jleaf_ir=jlb.finalize().ir,
               tleaf_ir=tlb.finalize().ir, summary=summary,
               aux=summary["scheduler_witness"]["aux_values"])
    for name in ("leaf", "node", "scheduler"):
        out[name + "_vk"] = _load(f"tower_golden_{name}_vk.json")
        out["j" + name], out["t" + name] = _proofs(
            f"tower_golden_{name}_proof.json")
    return out


def test_node_equal_to_jax_and_rejects_a_tampered_leaf(tower):
    t = tower
    jb, jlay = jnc.synthesize_node(t["jleaf_ir"], t["jcfg"], 1)
    tb, tlay = tnc.synthesize_node(t["tleaf_ir"], t["cfg"], 1)
    same_builders(jb, tb)
    ta = tnc.node_assignments(tlay, t["leaf_vk"], [t["tleaf"]])
    same_assignments(jnc.node_assignments(jlay, t["leaf_vk"], [t["jleaf"]]),
                     ta)
    tbuilt = tb.finalize()
    jb.finalize()
    W = same_witness(jb, tb, ta)
    pis = tnc.node_public_inputs(tlay, t["leaf_vk"], [t["tleaf"]])
    assert pis == [int(v) for v in t["tnode"].public_inputs]
    assert failing_gates(tb, ta) == 0
    assert violations(tbuilt, W, pis) == []
    bad = tnc.node_assignments(tlay, t["leaf_vk"],
                               [bump_first_pi(t["tleaf"])])
    assert failing_gates(tb, bad) > 0


def test_scheduler_multi_equal_to_jax_and_its_commitment(tower):
    t = tower
    jnb, _ = jnc.synthesize_node(t["jleaf_ir"], t["jcfg"], 1)
    tnb, _ = tnc.synthesize_node(t["tleaf_ir"], t["cfg"], 1)
    jnode_ir, tnode_ir = jnb.finalize().ir, tnb.finalize().ir
    jb, jlay = jsc.synthesize_scheduler_multi([(jnode_ir, t["jcfg"])], (8,),
                                              aux_len=len(t["aux"]))
    tb, tlay = tsc.synthesize_scheduler_multi([(tnode_ir, t["cfg"])], (8,),
                                              aux_len=len(t["aux"]))
    same_builders(jb, tb)
    args = ([t["node_vk"]], [t["tnode"]], 1, t["aux"])
    ta = tsc.scheduler_multi_assignments(tlay, *args)
    same_assignments(jsc.scheduler_multi_assignments(
        jlay, [t["node_vk"]], [t["jnode"]], 1, t["aux"]), ta)
    tbuilt = tb.finalize()
    jb.finalize()
    W = same_witness(jb, tb, ta)
    pis = tsc.scheduler_multi_public_inputs(tlay, *args, device="cpu")
    assert pis == [int(v) for v in t["tscheduler"].public_inputs] == \
        t["summary"]["scheduler_pi"]
    assert violations(tbuilt, W, pis) == []
    bad = tsc.scheduler_multi_assignments(
        tlay, [t["node_vk"]], [bump_first_pi(t["tnode"])], 1, t["aux"])
    assert failing_gates(tb, bad) > 0


def test_scheduler_aux_values_of_the_tower_block(tower):
    """The scheduler's aux vector of the golden tower block, from the port's
    dry block flow, equals the JAX package's."""
    from zkevm_harness_tpu_torch import harness
    from zkevm_harness_tpu_torch.vm import isa
    res = harness.run_block(golden.tower_block(isa), device="cpu")
    assert tsc.scheduler_aux_values(res.scheduler_witness) == tower["aux"]


@pytest.fixture(scope="module")
def blob_scheduler(tower):
    """The scheduler of the golden tower's block with one blob slot (the
    16-element blob circuit under the same config), synthesized in both
    packages, and the committed proofs of that chain
    (tools/gen_wrap_golden.py, stage `chain`): its node proof is the golden
    tower's, its blob proof `eip4844_n16_proof.json`."""
    from zkevm_harness_tpu.circuits import eip4844_circuit as je4
    t = tower
    with tly.engine_override(t["cfg"]):
        bsd, _ = tly.create_eip4844_setup_data(16, limb_bits=8, device="cpu")
    jl = je4.build_eip4844_program(16, limb_bits=8).layout
    jblob_ir = dataclasses.replace(
        jff.ff_ir(jl.params, jl.log_n, jl.num_rows, bind_c=jl.bind_c),
        public_input_cells=jl.pi_cells)
    summary = _load("wrap_blob_summary.json")
    aux = summary["aux_values"]
    jnb, _ = jnc.synthesize_node(t["jleaf_ir"], t["jcfg"], 1)
    tnb, _ = tnc.synthesize_node(t["tleaf_ir"], t["cfg"], 1)
    jb, jlay = jsc.synthesize_scheduler_multi(
        [(jnb.finalize().ir, t["jcfg"])], (8,), aux_len=len(aux),
        blob_children=[(jblob_ir, t["jcfg"])])
    tb, tlay = tsc.synthesize_scheduler_multi(
        [(tnb.finalize().ir, t["cfg"])], (8,), aux_len=len(aux),
        blob_children=[(bsd.ir, bsd.config)])
    jblob, tblob = _proofs("eip4844_n16_proof.json")
    jsched, tsched = _proofs("wrap_blob_scheduler_proof.json")
    return dict(jb=jb, jlay=jlay, tb=tb, tlay=tlay, tbuilt=tb.finalize(),
                aux=aux, summary=summary, blob_vk=bsd.vk, jblob=jblob,
                tblob=tblob, tsched=tsched,
                vk=_load("wrap_blob_scheduler_vk.json"))


def _blob_args(t, s, blob):
    return ([t["node_vk"]], [t["tnode"]], 1, s["aux"]), \
        dict(blob_vks=[s["blob_vk"]], blob_proofs=[blob])


def test_scheduler_with_a_blob_slot_equal_to_jax_and_the_golden(
        tower, blob_scheduler):
    """One type slot and one blob slot: the port's scheduler is the JAX
    package's, gate for gate and value for value, and its commitment over
    the aux values with the blob's output hash is the golden chain's."""
    t, s = tower, blob_scheduler
    assert s["aux"][:-8] == t["aux"]  # the blob's output hash comes last
    same_builders(s["jb"], s["tb"])
    args, blob = _blob_args(t, s, s["tblob"])
    ta = tsc.scheduler_multi_assignments(s["tlay"], *args, **blob)
    same_assignments(jsc.scheduler_multi_assignments(
        s["jlay"], [t["node_vk"]], [t["jnode"]], 1, s["aux"],
        blob_vks=[s["blob_vk"]], blob_proofs=[s["jblob"]]), ta)
    s["jb"].finalize()
    W = same_witness(s["jb"], s["tb"], ta)
    pis = tsc.scheduler_multi_public_inputs(s["tlay"], *args, **blob,
                                            device="cpu")
    assert pis == s["summary"]["scheduler_pi"] == \
        [int(v) for v in s["tsched"].public_inputs]
    assert violations(s["tbuilt"], W, pis) == []


def test_scheduler_with_a_blob_slot_verifies_the_golden_proof(
        blob_scheduler):
    """The port's verifier over that circuit and the golden VK accepts the
    golden scheduler proof and refuses it with its commitment changed."""
    s = blob_scheduler
    cfg = tpk.PlonkishConfig(**TOWER_CFG)
    ir = s["tbuilt"].ir
    assert tpk.verify(ir, s["vk"], s["tsched"], cfg, device="cpu")
    assert not tpk.verify(ir, s["vk"], bump_first_pi(s["tsched"]), cfg,
                          device="cpu")


@pytest.mark.slow
def test_scheduler_with_a_blob_slot_setup_gives_the_golden_vk(
        blob_scheduler):
    """The port's setup of that scheduler (2^15 x 60, minutes of the plain
    Poseidon2 on a CPU) gives the golden VK."""
    s = blob_scheduler
    cfg = tpk.PlonkishConfig(**TOWER_CFG)
    assert s["tbuilt"].setup(cfg, device="cpu").vk() == s["vk"]


def test_scheduler_with_a_blob_slot_rejects_a_tampered_blob_proof(
        tower, blob_scheduler):
    t, s = tower, blob_scheduler
    args, blob = _blob_args(t, s, bump_first_pi(s["tblob"]))
    assert failing_gates(s["tb"], tsc.scheduler_multi_assignments(
        s["tlay"], *args, **blob)) > 0


# -- the queue circuit and the recursion surface of layers ----------------------

def test_queue_circuit_equal_to_jax():
    log_n = 7
    n = 1 << log_n
    cycles = [[(c, k * 32 + 31), (c, (k + 1) * 32)]
              for k in range(n // 32 - 1) for c in range(8, 12)]
    dense = jpk.apply_copy_cycles(jpk.identity_permutation(12, n), cycles)
    want = convert.copy_wiring_from_dense(dense)
    got = tqc.queue_wiring(n)
    order = np.argsort(got.cells)
    assert np.array_equal(got.cells[order], want.cells)
    assert np.array_equal(got.succ[order], want.succ)
    tir, jir = tqc.queue_ir(log_n), jqc.queue_ir(log_n)
    assert tir.public_input_cells == jir.public_input_cells
    rng = np.random.default_rng(11)
    encs = [[int(x) for x in rng.integers(0, P, 8, dtype=np.uint64)]
            for _ in range(3)]
    head = [int(x) for x in rng.integers(0, P, 12, dtype=np.uint64)]
    jW = jqc.queue_witness(jir, encs, head=head)
    tW = tqc.queue_witness(tir, encs, head=head, device="cpu")
    assert np.array_equal(convert.pairs_to_u64(jW.lo, jW.hi),
                          tgl.to_u64(tW))
    assert tqc.expected_final_tail(encs, n // 32, head) == \
        [int(v) for v in jqc.expected_final_tail(encs, n // 32, head)]


def test_leaf_queue_segment_proof_and_recursion_surface():
    cfg = tpk.PlonkishConfig(**TOWER_CFG)
    rng = np.random.default_rng(2)
    q = FullWidthQueueSimulator(width=8, device="cpu")
    for _ in range(2):
        q.push([int(x) for x in rng.integers(0, P, 8, dtype=np.uint64)])
    task = create_leaf_witnesses(8, q, arity=2)[0]
    proof, vk = tly.prove_leaf_queue_segment(task, cfg, device="cpu")
    assert tly.verify_leaf_queue_segment(task, proof, vk, cfg, device="cpu")
    assert not tly.verify_leaf_queue_segment(task, bump_first_pi(proof), vk,
                                             cfg, device="cpu")
    assert sorted(tly.RECURSION_REGISTRY) == list(range(1, 16))
    with tly.engine_override(cfg):
        sd = tly.create_recursive_layer_setup_data(1, device="cpu")
        assert sd.ir.public_input_cells == tqc.queue_ir(8).public_input_cells
