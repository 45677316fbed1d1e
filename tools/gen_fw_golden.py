"""Write the golden artifacts of the BN254-hashed compression for the
wrapper and of the "binding" and "full" SNARK tiers, with the JAX package
on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_fw_golden.py [stage ...]

Stages (all by default, in this order):
  standin  test_artifacts/fw_standin_{vk,proof}.json: a for-wrapper proof
           (Poseidon2-BN254 trees and transcript) of the `queue_ir(5)`
           stand-in with witness [[1..8]] at rate 2, cap 4, 2 queries,
           final FRI size 8 (the fixture of tests/test_snark_fri_verifier.py);
           the VK is the Fr cap of the setup tree;
  mode1    test_artifacts/fw_mode1_{vk,proof}.json: compression mode 1 for
           the wrapper at `for_wrapper_engine_config(1)` (rate 2, cap 16,
           40 queries, final 32) over the golden tower's scheduler proof
           (test_artifacts/tower_golden_scheduler_*.json);
  binding  test_artifacts/fw_binding_snark_{vk,proof}.json: the "binding"
           BN254 PLONK wrapper over mode 1's Fr VK and the golden
           scheduler's public inputs;
  full     test_artifacts/fw_full_statement.json: the "full" tier's
           statement (the in-SNARK verifier of the stand-in proof):
           gate count, public inputs and the SHA-256 digests of its
           selectors, wiring, public gates and assignment
           (`convert.plonk_statement_digests`).

Every proof is verified before it is written, the "full" statement is
gate-checked; each stage prints its seconds. The PyTorch port is held
against these files value for value. Rerun only after an intentional
protocol change.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gen_wrap_golden import golden_scheduler_ir  # noqa: E402
from zkevm_harness_tpu.circuits import queue_circuit as qc  # noqa: E402
from zkevm_harness_tpu.ops import goldilocks as gl  # noqa: E402
from zkevm_harness_tpu.ops import ntt as nt  # noqa: E402
from zkevm_harness_tpu.prover import compression as cp  # noqa: E402
from zkevm_harness_tpu.prover import hash_backend as hb  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.utils import snark_fri_verifier as sfv  # noqa: E402
from zkevm_harness_tpu.utils import snark_wrapper as sw  # noqa: E402
from zkevm_harness_tpu_torch import convert  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
STANDIN = dict(rate=2, cap_size=4, num_queries=2, final_fri_size=8)


def _load(name):
    with open(os.path.join(OUT, name)) as f:
        return json.load(f)


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def _write_plonkish(stem, vk, proof):
    _write_json(f"{stem}_vk.json", [int(v) for v in vk])
    _write_json(f"{stem}_proof.json", serde.proof_to_json(proof))


def _standin_proof():
    cfg = pk.PlonkishConfig(**STANDIN)
    ir = qc.queue_ir(5)
    vk = _load("fw_standin_vk.json")
    proof = serde.proof_from_json(_load("fw_standin_proof.json"),
                                  serde.default_registry())
    return ir, cfg, vk, proof


def stage_standin():
    cfg = pk.PlonkishConfig(**STANDIN)
    ir = qc.queue_ir(5)
    setup = qc.queue_setup(ir, cfg)
    W = qc.queue_witness(ir, [[i + 1 for i in range(8)]])
    backend = hb.Bn254Backend()
    cols = gl.concatenate(
        [setup.const_cols, setup.sigma_cols, setup.table_cols], axis=0)
    tree = backend.commit_rows(
        gl.to_ints(nt.coset_lde(cols, cfg.rate)).T, cfg.cap_size)
    vk_fr = list(tree.cap)
    proof = pk.prove(ir, setup, W, cfg, backend=backend,
                     backend_setup=(vk_fr, tree))
    assert pk.verify(ir, vk_fr, proof, cfg, backend=backend)
    _write_plonkish("fw_standin", vk_fr, proof)


def stage_mode1():
    ir, cfg, vk = golden_scheduler_ir()
    proof = serde.proof_from_json(_load("tower_golden_scheduler_proof.json"),
                                  serde.default_registry())
    sched_pi = _load("tower_golden_summary.json")["scheduler_pi"]
    chain = ly.CompressionChain(ir, cfg, vk, wrapper_mode=1)
    out = cp.wrap_proof(proof, sched_pi, cp.WrapperConfig(1),
                        chain.prove_fn, chain.verify_fn)
    assert out["snark_public_input"] == cp.compress_stark_pi_to_snark_pi(
        sched_pi)
    _write_plonkish("fw_mode1", out["final_vk"], out["final_proof"])


def stage_binding():
    fw_vk = _load("fw_mode1_vk.json")
    sched_pi = _load("tower_golden_summary.json")["scheduler_pi"]
    setup, proof = sw.wrap_with_binding(fw_vk, sched_pi)
    assert sw.verify_binding_proof(setup.vk, proof, expected_fw_vk=fw_vk,
                                   expected_scheduler_pi=sched_pi)
    _write_json("fw_binding_snark_vk.json",
                convert.plonk_vk_to_json(setup.vk))
    _write_json("fw_binding_snark_proof.json",
                convert.plonk_proof_to_json(proof))


def stage_full():
    ir, cfg, vk, proof = _standin_proof()
    stats = sfv.gate_check_fw(ir, cfg, vk, proof)
    b, lay, _circ = sfv.build_cached(ir, cfg, len(vk))
    wires, pis = b.fill(sfv.fill_fw_assignments(lay, ir, cfg, vk, proof))
    out = convert.plonk_statement_digests(b, wires, pis)
    assert out["n_gates"] == stats["n_gates"]
    out["public_inputs"] = [str(int(v)) for v in pis]
    _write_json("fw_full_statement.json", out)


STAGES = {"standin": stage_standin, "mode1": stage_mode1,
          "binding": stage_binding, "full": stage_full}


def main():
    names = sys.argv[1:] or list(STAGES)
    for name in names:
        t0 = time.time()
        STAGES[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
