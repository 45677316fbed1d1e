"""Write the golden artifacts of the recursion tower and of the block
proving flow, with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_tower_golden.py [stage ...]

Stages (all by default, in this order):
  dry     test_artifacts/harness_dry_summary.json: `harness.run_block` of
          the block of tests/test_harness.py at `testing_geometry()`,
          `prove_mode="dry"`, summarised by
          `convert.block_proving_summary` (the proof DAG, every
          CircuitMaker's closed-form inputs and queue, the scheduler
          witness);
  tower   test_artifacts/tower_golden_{leaf,node,scheduler}_{vk,proof}.json
          and tower_golden_summary.json: `harness.run_block` of the block
          of tests/test_dag_tower.py with `prove_mode="spot"`,
          `spot_types=(8,)`, `tower=True`, under the config of that test
          (rate 2, cap 4, 2 queries, final FRI size 8) for base and
          recursion alike; every proof is verified before it is written.

Each stage prints its seconds. The PyTorch port is held against these
files value for value. Rerun only after an intentional protocol change.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from zkevm_harness_tpu import harness  # noqa: E402
from zkevm_harness_tpu.circuits import scheduler_circuit as sc  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.prover import scheduler as sch  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.vm import isa  # noqa: E402
from zkevm_harness_tpu_torch import convert, golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def summary(res):
    dag = sch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()})
    return convert.block_proving_summary(
        res, dag, sc.scheduler_aux_values(res.scheduler_witness))


def stage_dry():
    res = harness.run_block(golden.harness_block(isa), prove_mode="dry")
    _write_json("harness_dry_summary.json", summary(res))


def stage_tower():
    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    with ly.engine_override(cfg):
        res = harness.run_block(golden.tower_block(isa), prove_mode="spot",
                                spot_types=(8,), tower=True,
                                recursion_cfg=cfg)
    src = res.source
    records = {"leaf": src.get_leaf_layer_proof(10, 0),
               "node": src.get_node_layer_proof(8, 0, 0),
               "scheduler": src.get_scheduler_proof()}
    for name, rec in records.items():
        assert rec and rec.get("real"), name
        _write_json(f"tower_golden_{name}_vk.json",
                    [int(v) for v in rec["vk"]])
        _write_json(f"tower_golden_{name}_proof.json",
                    serde.proof_to_json(rec["proof"]))
    out = summary(res)
    out["scheduler_pi"] = [int(v) for v in records["scheduler"]
                           ["scheduler_pi"]]
    out["base_8_public_inputs"] = [
        int(v) for v in src.get_base_layer_proof(8, 0)["public_inputs"]]
    _write_json("tower_golden_summary.json", out)


STAGES = {"dry": stage_dry, "tower": stage_tower}


def main():
    names = sys.argv[1:] or list(STAGES)
    for name in names:
        t0 = time.time()
        STAGES[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
