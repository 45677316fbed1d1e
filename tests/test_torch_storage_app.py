"""The port's storage-application circuit (type 10) — Blake2s Merkle paths
in-circuit (`circuits/storage_application_circuit.py`), the sparse state
tree (`witness/tree.py`), the decomposer (`witness/storage_application.py`)
and the typed layer functions — held against the JAX package and the
committed golden artifacts (`tools/gen_block_golden.py`), bit for bit
(tolerance 0).

Tier-1 tests stay cheap: the depth-4 golden path (2,609 columns at 2^6
rows), host Python and numpy on both sides, and the setup's VK (a few
seconds). The golden proof through the port's prover on the CPU and a
depth-256 path (2^12 rows) are `slow`.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zkevm_harness_tpu.circuits import storage_application_circuit as jsa
from zkevm_harness_tpu.vm.environment import LogQuery as JLogQuery
from zkevm_harness_tpu.witness import storage_application as jwsa
from zkevm_harness_tpu.witness import tree as jtree
from zkevm_harness_tpu_torch import convert, golden
from zkevm_harness_tpu_torch.circuits import \
    storage_application_circuit as tsa
from zkevm_harness_tpu_torch.ops import goldilocks as tgl
from zkevm_harness_tpu_torch.prover import layers as tly
from zkevm_harness_tpu_torch.prover import plonkish as tpk
from zkevm_harness_tpu_torch.prover import satisfy
from zkevm_harness_tpu_torch.prover.stark import (DeviceAlgebra,
                                                  HostExtAlgebra)
from zkevm_harness_tpu_torch.utils import serde
from zkevm_harness_tpu_torch.vm.environment import LogQuery as TLogQuery
from zkevm_harness_tpu_torch.witness import storage_application as twsa
from zkevm_harness_tpu_torch.witness import tree as ttree

P = tgl.P
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CFG = tpk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
DEPTH = golden.STORAGE_APP_DEPTH


def _load(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _u64(gf):
    return np.asarray(gf.lo).astype(np.uint64) | \
        (np.asarray(gf.hi).astype(np.uint64) << np.uint64(32))


def _path(mod):
    return mod.PathInstanceInputs(
        leaf_preimage=golden.STORAGE_APP_LEAF,
        path_bits=list(golden.STORAGE_APP_PATH_BITS),
        siblings=list(golden.STORAGE_APP_SIBLINGS))


@pytest.mark.parametrize("data", [b"", b"abc", b"x" * 40, b"y" * 64,
                                  bytes(range(64))])
def test_blake2s_compress_matches_hashlib(data):
    want = hashlib.blake2s(data).digest()
    assert tsa.blake2s_digest(data) == jsa.blake2s_digest(data) == want
    padded = data + bytes(64 - len(data))
    words = [int.from_bytes(padded[4 * i:4 * i + 4], "little")
             for i in range(16)]
    assert tsa.blake2s_compress(words, len(data)) == \
        jsa.blake2s_compress(words, len(data))


def test_ir_metadata_and_const_rows_equal():
    for depth in (DEPTH, 256):
        tg, jg = tsa.PathGeometry(depth), jsa.PathGeometry(depth)
        assert (tg.log_n, tg.rows) == (jg.log_n, jg.rows)
        tir, jir = tsa.path_ir(tg), jsa.path_ir(jg)
        for f in ("log_n", "num_witness", "num_const", "gate_degree",
                  "num_gate_constraints", "copy_chunk", "public_input_cells",
                  "lookup_sets"):
            assert getattr(tir, f) == getattr(jir, f), f
        want = np.asarray(jsa._const_rows(jg), dtype=object).astype(np.uint64)
        assert np.array_equal(tsa._const_rows(tg), want)
    assert tir.num_witness == 2609 and tir.num_gate_constraints == 5905


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_values_equal_on_random_rows(seed):
    """Random (non-boolean) rows exercise every constraint as a
    polynomial: the stacked families of the device algebra and the host
    loop give the JAX package's values, in its order."""
    tir, jir = tsa.path_ir(tsa.PathGeometry(DEPTH)), \
        jsa.path_ir(jsa.PathGeometry(DEPTH))
    rows = 2
    rng = np.random.default_rng(seed)
    W = rng.integers(0, P, size=(tir.num_witness, rows), dtype=np.uint64)
    C = rng.integers(0, P, size=(tir.num_const, rows), dtype=np.uint64)
    Wt, Ct = tgl.from_u64(W, "cpu"), tgl.from_u64(C, "cpu")
    dev = tir.eval_gates(DeviceAlgebra(), list(Wt.unbind(0)),
                         list(torch.roll(Wt, -1, 1).unbind(0)),
                         list(Ct.unbind(0)))
    assert len(dev) == tir.num_gate_constraints
    got = np.stack([tgl.to_u64(v.expand(rows)) for v in dev])
    for r in range(rows):
        w = [(int(W[i, r]), 0) for i in range(tir.num_witness)]
        wn = [(int(W[i, (r + 1) % rows]), 0) for i in range(tir.num_witness)]
        c = [(int(C[i, r]), 0) for i in range(tir.num_const)]
        want = jir.eval_gates(HostExtAlgebra(), w, wn, c)
        assert [v[0] for v in want] == [int(v) for v in got[:, r]]
        assert tir.eval_gates(HostExtAlgebra(), w, wn, c) == want


def test_witness_pis_and_root_equal():
    tg, jg = tsa.PathGeometry(DEPTH), jsa.PathGeometry(DEPTH)
    tir, jir = tsa.path_ir(tg), jsa.path_ir(jg)
    tW = tsa.path_witness(tir, tg, _path(tsa), device="cpu")
    jpath = convert.path_inputs_from(_path(tsa), jsa.PathInstanceInputs)
    assert dataclasses.astuple(jpath) == dataclasses.astuple(_path(jsa))
    assert np.array_equal(tgl.to_u64(tW),
                          _u64(jsa.path_witness(jir, jg, jpath)))
    pis = tsa.expected_public_inputs(tg, _path(tsa))
    assert pis == jsa.expected_public_inputs(jg, _path(jsa))
    assert satisfy.check_satisfied(tir, tgl.to_u64(tW), tsa._const_rows(tg).T,
                                   tpk.CopyWiring.identity(), pis) == []
    dig = ttree.leaf_hash(7, golden.STORAGE_APP_LEAF[8:])
    for bit, sib in zip(golden.STORAGE_APP_PATH_BITS,
                        golden.STORAGE_APP_SIBLINGS):
        dig = ttree.node_hash(sib, dig) if bit else ttree.node_hash(dig, sib)
    assert tsa.root_bytes(tg, pis) == jsa.root_bytes(jg, pis) == dig
    # the golden proof's public inputs are these
    assert [int(v) for v in _load(f"storage_app_d{DEPTH}_proof.json")
            ["fields"]["public_inputs"]] == pis


def test_a_broken_witness_is_reported():
    tg = tsa.PathGeometry(DEPTH)
    tir = tsa.path_ir(tg)
    W = tgl.to_u64(tsa.path_witness(tir, tg, _path(tsa), device="cpu")).copy()
    W[tsa._C.GA1 + 5, 3] ^= np.uint64(1)  # one bit of a G word
    out = satisfy.check_satisfied(tir, W, tsa._const_rows(tg).T,
                                  tpk.CopyWiring.identity())
    assert out and all(v.startswith("gate") for v in out)


def _random_tree_ops(depth, seed, n):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n // 2)]
    return [(keys[int(rng.integers(len(keys)))], rng.bytes(32))
            for _ in range(n)]


@pytest.mark.parametrize("depth", [8, 256])
def test_sparse_tree_equal_after_the_same_inserts(depth):
    t, j = ttree.SparseStorageTree(depth), jtree.SparseStorageTree(depth)
    assert t.root == j.root and t.empty_hashes == j.empty_hashes
    ops = _random_tree_ops(depth, depth, 24)
    idx, vals = [k for k, _ in ops], [v for _, v in ops]
    assert t.filter_renumerate(idx, vals)[0] == \
        j.filter_renumerate(idx, vals)[0]
    for k, v in ops:
        a, b = t.insert_leaf(k, v), j.insert_leaf(k, v)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert t.root == j.root
        assert ttree.SparseStorageTree.verify_inclusion(t.root, a)
    for k, _ in ops[:5]:
        assert dataclasses.astuple(t.get_leaf(k)) == \
            dataclasses.astuple(j.get_leaf(k))
    assert t.next_enumeration_index == j.next_enumeration_index


def _queries(cls, seed):
    """Deduplicated storage queries (writes and protective reads of slots
    the tree holds or not)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(9):
        key = int(rng.integers(4))
        if i % 3 == 2:
            out.append(cls(i, 0, 0, 0, 0xB0, key, 0, 0, rw_flag=False))
        else:
            out.append(cls(i, 0, 0, 0, 0xB0, 100 + i, 0,
                           int(rng.integers(1 << 62)), rw_flag=True))
    return out


@pytest.mark.parametrize("capacity", [1, 4, 33])
def test_compute_storage_application_artifacts_equal(capacity):
    seeded = {(0, 0xB0, 1): 5, (0, 0xB0, 3): 9}
    arts = []
    for tree_mod, wsa, cls in ((ttree, twsa, TLogQuery),
                               (jtree, jwsa, JLogQuery)):
        tree = tree_mod.SparseStorageTree(depth=16)
        for (_s, addr, key), v in sorted(seeded.items()):
            tree.insert_leaf(wsa.storage_key_to_index(addr, key),
                             v.to_bytes(32, "big"))
        qs = [q if q.rw_flag or (0, 0xB0, q.key) not in seeded
              else dataclasses.replace(q, read_value=seeded[(0, 0xB0, q.key)])
              for q in _queries(cls, 5)]
        arts.append(wsa.compute_storage_application_artifacts(tree, qs,
                                                              capacity))
    t, j = arts
    assert (t.initial_root, t.final_root) == (j.initial_root, j.final_root)
    assert t.initial_root != t.final_root
    assert [[dataclasses.astuple(p) for p in pair] for pair in t.instances] \
        == [[dataclasses.astuple(p) for p in pair] for pair in j.instances]

    def plain(w):
        d = dataclasses.asdict(w)
        for q in d["queries"]:
            q["query"] = tuple(q["query"].values())
        return d
    assert [plain(w) for w in t.query_witnesses] == \
        [plain(w) for w in j.query_witnesses]


def test_vk_equals_the_golden():
    with tly.engine_override(CFG):
        sd, _geo = tly.storage_application_setup_data(depth=DEPTH,
                                                      device="cpu")
    assert sd.vk == _load(f"storage_app_d{DEPTH}_vk.json")
    tly._SETUP_CACHE.clear()


@pytest.mark.slow
def test_golden_proof_on_the_cpu():
    inst = _path(tsa)
    with tly.engine_override(CFG):
        proof = tly.prove_storage_application_path(inst, device="cpu")
        assert json.loads(json.dumps(serde.proof_to_json(proof))) == \
            _load(f"storage_app_d{DEPTH}_proof.json")
        assert tly.verify_storage_application_path(inst, proof, device="cpu")
    tly._SETUP_CACHE.clear()


@pytest.mark.slow
def test_depth_256_path_satisfied_and_equal():
    """A depth-256 write path of the small whole block: the port's witness
    equals the JAX package's and satisfies every constraint exactly, its
    root that of the artifacts' tree."""
    from zkevm_harness_tpu_torch.circuits.types import testing_geometry
    from zkevm_harness_tpu_torch.witness import oracle
    tracer, pre = golden.trace_whole_block(**golden.WHOLE_GOLDEN)
    art = oracle.create_artifacts_from_tracer(tracer, testing_geometry(),
                                              initial_storage=pre,
                                              device="cpu")
    sa = art.storage_application
    read, write = sa.instances[0]
    tg, jg = tsa.PathGeometry(256), jsa.PathGeometry(256)
    tir, jir = tsa.path_ir(tg), jsa.path_ir(jg)
    jwrite = convert.path_inputs_from(write, jsa.PathInstanceInputs)
    tW = tsa.path_witness(tir, tg, write, device="cpu")
    assert np.array_equal(tgl.to_u64(tW), _u64(jsa.path_witness(jir, jg,
                                                                jwrite)))
    pis = tsa.expected_public_inputs(tg, write)
    assert satisfy.check_satisfied(tir, tgl.to_u64(tW), tsa._const_rows(tg).T,
                                   tpk.CopyWiring.identity(), pis) == []
    assert tsa.root_bytes(tg, tsa.expected_public_inputs(tg, read)) == \
        sa.initial_root
    if len(sa.instances) == 1:
        assert tsa.root_bytes(tg, pis) == sa.final_root
