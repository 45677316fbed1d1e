"""Write the golden artifacts of storage application's (type 10) recursion
tower at `leaf_arity=2`, with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_type10_golden.py

The tower is that of the JAX package's own `tests/test_type10_tower.py`:
the block `golden.type10_block` (one storage write, so one read and one
write path instance) at `testing_geometry()` with the storage tree cut to
`golden.TYPE10_GOLDEN["depth"]`, `harness.run_block(prove_mode="spot",
spot_types=(10,), tower=True, leaf_arity=golden.TYPE10_GOLDEN["leaf_arity"])`
under `golden.TOWER_GOLDEN_CONFIG` for base and recursion alike; every proof
is verified before it is kept. Each record is written under
`<tmp>/type10_golden/` as soon as it is made, and a second run resumes from
those (skip-if-present), so a run that is cut keeps what it proved. Under
`test_artifacts/`:

  tower10_base_proofs.json                 the two path proofs, in order;
  tower10_{leaf,node}_{vk,proof}.json      the leaf over both, the node
                                           over the leaf;
  tower10_scheduler_{vk,proof}.json        the scheduler over type 10's slot;
  tower10_summary.json                     the flow's summary
          (`convert.block_proving_summary`), the scheduler's public inputs,
          and the leaf's arity, queue head and tail, base VK, gate and
          circuit digests and the digest of its filled witness.

Prints its seconds. The PyTorch port is held against these files value for
value (`tests/test_torch_tower13.py`, `chip_smoke.py` phase
`tower13_golden`). Rerun only after an intentional protocol change.
"""

import dataclasses
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
from zkevm_harness_tpu.circuits.types import testing_geometry  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.prover import scheduler as sch  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.utils.data_source import \
    InMemoryDataSource  # noqa: E402
from zkevm_harness_tpu.vm import isa  # noqa: E402
from zkevm_harness_tpu_torch import convert, golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
RECORDS = os.path.join(tempfile.gettempdir(), "type10_golden")
CFG = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
T = 10


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


class _KeptSource(InMemoryDataSource):
    """The flow's data source, each record also written to `RECORDS` as it
    is stored and read back from there on a second run."""

    def __init__(self):
        super().__init__()
        os.makedirs(RECORDS, exist_ok=True)
        reg = serde.default_registry()
        for name in sorted(os.listdir(RECORDS)):
            with open(os.path.join(RECORDS, name)) as f:
                key, value = json.load(f)
            self._store[tuple(key)] = serde.proof_from_json(value, reg)

    def set(self, value, *key):
        super().set(value, *key)
        name = "_".join(str(k) for k in key) + ".json"
        _write_json(os.path.join(RECORDS, name),
                    [list(key), serde.proof_to_json(value)])
        print(f"stored {key} at {time.strftime('%H:%M:%S')}", flush=True)


def main():
    t0 = time.time()
    geo = dataclasses.replace(testing_geometry(),
                              storage_tree_depth=golden.TYPE10_GOLDEN["depth"])
    arity = golden.TYPE10_GOLDEN["leaf_arity"]
    with ly.engine_override(CFG):
        res = harness.run_block(golden.type10_block(isa), geometry=geo,
                                prove_mode="spot", spot_types=(T,),
                                tower=True, recursion_cfg=CFG,
                                leaf_arity=arity, source=_KeptSource())
    src, rigs = res.source, res.recursion_rigs
    dag = sch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()},
        leaf_arity=arity)
    (task,) = [t for t in dag if t.kind == "leaf"
               and t.payload.base_circuit_type == T]
    lw = task.payload
    rec = src.get_leaf_layer_proof(int(task.circuit_type), 0)
    node = src.get_node_layer_proof(T, 0, 0)
    srec = src.get_scheduler_proof()
    assert rec["real"] and node["real"] and srec["real"]
    chunk = [src.get_base_layer_proof(T, d.index)["proof"] for d in task.deps]
    key = next(k for k in rigs if k[0] == "leaf" and k[1] == T)
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
    _write_json(os.path.join(OUT, "tower10_base_proofs.json"),
                [serde.proof_to_json(p) for p in chunk])
    for kind, r in (("leaf", rec), ("node", node), ("scheduler", srec)):
        _write_json(os.path.join(OUT, f"tower10_{kind}_vk.json"),
                    [int(v) for v in r["vk"]])
        _write_json(os.path.join(OUT, f"tower10_{kind}_proof.json"),
                    serde.proof_to_json(r["proof"]))
    summary = convert.block_proving_summary(
        res, dag, sc.scheduler_aux_values(res.scheduler_witness))
    summary.update(spot_types=[T], config=golden.TOWER_GOLDEN_CONFIG,
                   golden=golden.TYPE10_GOLDEN, leaf=leaf,
                   scheduler_pi=[int(v) for v in srec["scheduler_pi"]])
    _write_json(os.path.join(OUT, "tower10_summary.json"), summary)
    print(f"type 10 tower: leaf arity {leaf['arity']}, {leaf['gates']} "
          f"gates; {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
