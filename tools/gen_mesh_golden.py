"""Write the golden artifacts of the column-sharded prove, with the JAX
package's `parallel.mesh.prove_column_sharded` on an 8-device virtual CPU
mesh:

    python tools/gen_mesh_golden.py [stage ...]

Stages (all by default, in this order):
  test_shape    test_artifacts/mesh_log6_w16_{vk,proof}.json: the flagship
                at log_n 6, width 16 (rate 2, cap 4, 8 queries, final 8,
                witness seed 0), the shape of `tests/test_mesh.py`'s
                sharded prove;
  dryrun_shape  test_artifacts/mesh_log9_w64_{vk,proof}.json: the flagship
                at log_n 9, width 64 (rate 2, cap 8, 8 queries, final 16,
                witness seed 0), the shape of `__graft_entry__.py`'s
                multi-chip dry run.

Each proof is verified and checked equal to the one-device prove's
transcript before it is written. Each stage prints its seconds. The PyTorch
port's `parallel.mesh.prove_column_sharded` is held against these files byte
for byte. Rerun only after an intentional protocol change.
"""

import json
import os
import sys
import time

# Eight virtual CPU devices, set before JAX is imported (as tests/conftest.py).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from zkevm_harness_tpu.circuits import flagship as fl  # noqa: E402
from zkevm_harness_tpu.parallel import mesh as pm  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")

SHAPES = {
    "test_shape": ("mesh_log6_w16", dict(log_n=6, width=16),
                   dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8)),
    "dryrun_shape": ("mesh_log9_w64", dict(log_n=9, width=64),
                     dict(rate=2, cap_size=8, num_queries=8,
                          final_fri_size=16)),
}


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def stage(key):
    name, shape, cfg_kw = SHAPES[key]
    cfg = pk.PlonkishConfig(**cfg_kw)
    ir = fl.flagship_ir(**shape)
    setup = fl.flagship_setup(ir, cfg)
    witness = fl.flagship_witness(ir, seed=0)
    proof = pm.prove_column_sharded(ir, setup, witness, cfg, pm.make_mesh(8))
    assert pk.verify(ir, setup.vk(), proof, cfg)
    one = pk.prove(ir, setup, witness, cfg)
    assert serde.proof_to_json(one) == serde.proof_to_json(proof), \
        "the sharded proof differs from the one-device proof"
    _write_json(f"{name}_vk.json", [int(v) for v in setup.vk()])
    _write_json(f"{name}_proof.json", serde.proof_to_json(proof))


def main(argv):
    stages = argv or list(SHAPES)
    for key in stages:
        t0 = time.time()
        stage(key)
        print(f"{key}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
