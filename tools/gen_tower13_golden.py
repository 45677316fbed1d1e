"""Write the golden artifacts of the whole block's recursion tower over the
base types beyond 7, 8 and 10, with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_tower13_golden.py subtree 1,5,13 &
    JAX_PLATFORMS=cpu python tools/gen_tower13_golden.py subtree \
        2,3,4,6,9,11,12 &
    wait
    JAX_PLATFORMS=cpu python tools/gen_tower13_golden.py scheduler

(4,888.0 s and 3,440.6 s side by side, then 1,072.4 s, on a shared 8-core
CPU.)

The tower is `harness.run_block` of the small whole block
(`golden.WHOLE_GOLDEN` at `testing_geometry()`: storage application at
depth 4, every base type filled) with `prove_mode="spot"`,
`spot_types=golden.TOWER13_GOLDEN_TYPES` and `tower=True`, under
`golden.TOWER_GOLDEN_CONFIG` (rate 2, cap 4, 2 queries, final FRI size 8)
for base and recursion alike; every proof is verified before it is kept.
A type's base, leaf and node tasks depend on that type alone, so stage
`subtree T,...` runs `run_block` over those types (processes side by side
take a few types each; one process over all of them holds every type's
circuits at once), writes their files and keeps the data source's records
under `<tmp>/tower13_golden/`; stage `scheduler` then runs `run_block`
over all the types on those records, which resumes every base, leaf and
node task (skip-if-present) and proves the scheduler. Under
`test_artifacts/`:

  tower13_leaf_<t>_{vk,proof}.json, tower13_node_<t>_{vk,proof}.json
          the leaf and node of each base type t;
  tower13_base_<t>_proofs.json
          the base proofs each leaf verifies, in its order;
  tower13_scheduler_{vk,proof}.json
          the scheduler over the types' slots;
  tower13_summary.json
          the flow's summary (`convert.block_proving_summary`), the
          scheduler's public inputs, and per type the leaf's arity, its
          queue head and tail, the base VK, its gate and circuit digests
          and the digest of its filled witness
          (`convert.builder_circuit_digests`,
          `convert.field_values_sha256`).

Prints each stage's seconds. The PyTorch port is held against these files
value for value (`tests/test_torch_tower13.py`, `chip_smoke.py` phase
`tower13_golden`). Rerun only after an intentional protocol change.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from zkevm_harness_tpu import harness  # noqa: E402
from zkevm_harness_tpu.circuits import leaf_circuit as lc  # noqa: E402
from zkevm_harness_tpu.circuits import scheduler_circuit as sc  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.prover import scheduler as sch  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.utils.data_source import \
    InMemoryDataSource  # noqa: E402
from zkevm_harness_tpu.vm import isa  # noqa: E402
from zkevm_harness_tpu_torch import convert, golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
RECORDS = os.path.join(tempfile.gettempdir(), "tower13_golden")
CFG = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _run(types, source=None):
    contracts = dict(golden.hash_callees(
        isa, golden.WHOLE_GOLDEN["callee_reps"]))
    with ly.engine_override(CFG):
        return harness.run_block(
            golden.whole_block(isa, **golden.WHOLE_GOLDEN),
            prove_mode="spot", spot_types=tuple(types), contracts=contracts,
            tower=True, recursion_cfg=CFG, source=source)


def _dag(res):
    return sch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()})


def stage_subtree(types):
    assert set(types) <= set(golden.TOWER13_GOLDEN_TYPES), types
    res = _run(types)
    src, rigs = res.source, res.recursion_rigs
    os.makedirs(RECORDS, exist_ok=True)
    for task in _dag(res):
        if task.kind != "leaf" or task.payload.base_circuit_type not in types:
            continue
        lw = task.payload
        t = lw.base_circuit_type
        assert lw.index == 0, "one leaf a type at this block"
        rec = src.get_leaf_layer_proof(int(task.circuit_type), 0)
        node = src.get_node_layer_proof(t, 0, 0)
        assert rec and rec.get("real") and node and node.get("real"), t
        chunk = [src.get_base_layer_proof(t, d.index)["proof"]
                 for d in task.deps]
        key = next(k for k in rigs if k[0] == "leaf" and k[1] == t)
        b, lay, built, _setup, sd = rigs[key]
        W = b.fill_witness(lc.leaf_assignments(lay, sd.vk, chunk,
                                               queue_head=lw.queue_head))
        leaf = dict(
            arity=int(rec["arity"]), num_real=int(rec["num_real"]),
            queue_head=[int(v) for v in lw.queue_head],
            queue_tail=[int(v) for v in lw.queue_tail],
            base_vk=[int(v) for v in sd.vk],
            witness_sha256=convert.field_values_sha256(
                (np.asarray(W.lo), np.asarray(W.hi))),
            **convert.builder_circuit_digests(b, built))
        _write_json(os.path.join(RECORDS, f"leaf_{t}.json"), leaf)
        _write_json(os.path.join(OUT, f"tower13_base_{t}_proofs.json"),
                    [serde.proof_to_json(p) for p in chunk])
        for kind, r in (("leaf", rec), ("node", node)):
            _write_json(os.path.join(OUT, f"tower13_{kind}_{t}_vk.json"),
                        [int(v) for v in r["vk"]])
            _write_json(os.path.join(OUT, f"tower13_{kind}_{t}_proof.json"),
                        serde.proof_to_json(r["proof"]))
        # the type's base, leaf and node records, for stage `scheduler`
        keep = [[list(k), serde.proof_to_json(v)]
                for k, v in src._store.items()
                if (k[0] == "leaf_proof" and k[1] == task.circuit_type)
                or (k[0] in ("base_proof", "node_proof", "base_padding")
                    and k[1] == t)]
        _write_json(os.path.join(RECORDS, f"records_{t}.json"), keep)
        print(f"type {t}: arity {rec['arity']}, {leaf['gates']} gates",
              flush=True)


def stage_scheduler():
    types = tuple(golden.TOWER13_GOLDEN_TYPES)
    src = InMemoryDataSource()
    reg = serde.default_registry()
    for t in types:
        for k, v in _load_json(os.path.join(RECORDS, f"records_{t}.json")):
            src._store[tuple(k)] = serde.proof_from_json(v, reg)
    res = _run(types, source=src)
    srec = res.source.get_scheduler_proof()
    assert srec and srec.get("real") and srec["types"] == sorted(types)
    _write_json(os.path.join(OUT, "tower13_scheduler_vk.json"),
                [int(v) for v in srec["vk"]])
    _write_json(os.path.join(OUT, "tower13_scheduler_proof.json"),
                serde.proof_to_json(srec["proof"]))
    summary = convert.block_proving_summary(
        res, _dag(res), sc.scheduler_aux_values(res.scheduler_witness))
    summary.update(
        spot_types=list(types), config=golden.TOWER_GOLDEN_CONFIG,
        block=golden.WHOLE_GOLDEN,
        leaves={str(t): _load_json(os.path.join(RECORDS, f"leaf_{t}.json"))
                for t in types},
        scheduler_pi=[int(v) for v in srec["scheduler_pi"]])
    _write_json(os.path.join(OUT, "tower13_summary.json"), summary)


def main():
    stage, args = sys.argv[1], sys.argv[2:]
    t0 = time.time()
    if stage == "subtree":
        stage_subtree(tuple(int(t) for t in args[0].split(",")))
    elif stage == "scheduler":
        stage_scheduler()
    else:
        raise SystemExit(f"unknown stage {stage!r}")
    print(f"{stage} {' '.join(args)}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
