"""Write the golden artifacts of the compression chain, the "pi" SNARK
wrapper and the EIP-4844 branch, with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_wrap_golden.py [stage ...]

Stages (all by default, in this order):
  standin  test_artifacts/wrap_standin_{scheduler,mode1..mode5}_{vk,proof}
           .json: the five-mode compression chain of
           tests/test_compression.py over its `queue_ir(5)` stand-in
           scheduler (scheduler config rate 2, cap 4, 2 queries, final FRI
           size 8; every mode at rate 2, cap 4, 1 query, final 8);
  mode1    test_artifacts/wrap_mode1_{vk,proof}.json: compression mode 1 at
           its production config (`compression_engine_config(1)`: LDE 32,
           cap 16, 40 queries, final 32) over the golden tower's scheduler
           proof (test_artifacts/tower_golden_scheduler_*.json, the circuit
           re-synthesized from the golden tower's block and config);
  snark    test_artifacts/wrap_snark_pi_{vk,proof}.json: the "pi" BN254
           PLONK wrapper proof of that scheduler's public inputs;
  eip4844  test_artifacts/eip4844_golden.json (the 16-point testing KZG
           settings and the witness chain of the blob `bytes(range(256)) *
           2`, first 496 bytes) and eip4844_n16_{vk,proof}.json (the blob
           circuit at 16 elements, u8 limbs, under the golden tower's
           config);
  chain    test_artifacts/wrap_blob_{scheduler,mode1}_{vk,proof}.json,
           wrap_blob_snark_pi_proof.json and wrap_blob_summary.json: the
           JAX package's `full_chain.prove_block_full_chain` over the golden
           tower's block and config with that blob (KZG testing domain 16)
           in the scheduler's blob slot, mode 1 at its production config and
           the "pi" SNARK; the summary holds the scheduler's aux values and
           public inputs and the SNARK public input.

Every proof is verified before it is written; each stage prints its
seconds. The PyTorch port is held against these files value for value.
Rerun only after an intentional protocol change.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from zkevm_harness_tpu.circuits import leaf_circuit as lc  # noqa: E402
from zkevm_harness_tpu.circuits import node_circuit as nc  # noqa: E402
from zkevm_harness_tpu.circuits import queue_circuit as qc  # noqa: E402
from zkevm_harness_tpu.circuits import ram_permutation_circuit as rc  # noqa
from zkevm_harness_tpu.circuits import scheduler_circuit as sc  # noqa: E402
from zkevm_harness_tpu.circuits.types import testing_geometry  # noqa: E402
from zkevm_harness_tpu.prover import compression as cp  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.utils import kzg  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.utils import snark_wrapper as sw  # noqa: E402
from zkevm_harness_tpu.utils.data_source import InMemoryDataSource  # noqa
from zkevm_harness_tpu.utils.native import keccak256  # noqa: E402
from zkevm_harness_tpu.witness import eip4844 as w4844  # noqa: E402
from zkevm_harness_tpu_torch import convert, golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
STANDIN_SCHED = dict(rate=2, cap_size=4, num_queries=2, final_fri_size=8)
STANDIN_MODE = dict(rate=2, cap_size=4, num_queries=1, final_fri_size=8)
BLOB = (bytes(range(256)) * 2)[:31 * 16]


def _load(name):
    with open(os.path.join(OUT, name)) as f:
        return json.load(f)


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def _write_plonkish(stem, vk, proof):
    _write_json(f"{stem}_vk.json", [int(v) for v in vk])
    _write_json(f"{stem}_proof.json", serde.proof_to_json(proof))


def stage_standin():
    sched_cfg = pk.PlonkishConfig(**STANDIN_SCHED)
    red = pk.PlonkishConfig(**STANDIN_MODE)
    ir = qc.queue_ir(5)
    setup = qc.queue_setup(ir, sched_cfg)
    W = qc.queue_witness(ir, [[i + 1 for i in range(8)]])
    sched_proof = pk.prove(ir, setup, W, sched_cfg)
    assert pk.verify(ir, setup.vk(), sched_proof, sched_cfg)
    _write_plonkish("wrap_standin_scheduler", setup.vk(), sched_proof)
    chain = ly.CompressionChain(ir, sched_cfg, setup.vk(),
                                outer_cfgs={m: red for m in range(1, 6)})
    src = InMemoryDataSource()
    out = cp.wrap_proof(sched_proof, sched_proof.public_inputs[:4],
                        cp.WrapperConfig(5), chain.prove_fn, chain.verify_fn,
                        src)
    for mode in range(1, 6):
        proof = (src.get_compression_proof(mode) if mode < 5
                 else out["final_proof"])
        _write_plonkish(f"wrap_standin_mode{mode}",
                        chain._inner[mode + 1][2], proof)


def golden_scheduler_ir():
    """The golden tower's scheduler circuit, re-synthesized: RAM permutation
    at testing geometry -> leaf of arity 2 -> node of arity 1 -> the
    one-slot scheduler over the tower block's aux values."""
    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    geo = ly.ram_geometry_for_capacity(
        testing_geometry().cycles_per_ram_permutation)
    leaf_b, _ = lc.synthesize_leaf(rc.ram_ir(geo.log_n, geo.tiles_per_queue),
                                   cfg, 2, 8)
    node_b, _ = nc.synthesize_node(leaf_b.finalize().ir, cfg, 1)
    aux = _load("tower_golden_summary.json")["scheduler_witness"][
        "aux_values"]
    sb, _ = sc.synthesize_scheduler_multi([(node_b.finalize().ir, cfg)],
                                          (8,), aux_len=len(aux))
    built = sb.finalize()
    vk = _load("tower_golden_scheduler_vk.json")
    assert [int(v) for v in built.setup(cfg).vk()] == vk
    return built.ir, cfg, vk


def stage_mode1():
    ir, cfg, vk = golden_scheduler_ir()
    proof = serde.proof_from_json(_load("tower_golden_scheduler_proof.json"),
                                  serde.default_registry())
    sched_pi = _load("tower_golden_summary.json")["scheduler_pi"]
    chain = ly.CompressionChain(ir, cfg, vk)
    out = cp.wrap_proof(proof, sched_pi, cp.WrapperConfig(1),
                        chain.prove_fn, chain.verify_fn)
    assert out["snark_public_input"] == cp.compress_stark_pi_to_snark_pi(
        sched_pi)
    _write_plonkish("wrap_mode1", out["final_vk"], out["final_proof"])


def stage_snark():
    sched_pi = _load("tower_golden_summary.json")["scheduler_pi"]
    wsetup = sw.wrapper_setup()
    proof = sw.wrap_scheduler_pi(wsetup, sched_pi)
    assert sw.verify_wrapped_proof(wsetup.vk, proof,
                                   expected_scheduler_pi=sched_pi)
    _write_json("wrap_snark_pi_vk.json", convert.plonk_vk_to_json(wsetup.vk))
    _write_json("wrap_snark_pi_proof.json",
                convert.plonk_proof_to_json(proof))


def stage_eip4844():
    settings = kzg.KzgSettings.testing(16)
    wit = w4844.generate_eip4844_witness(BLOB, settings)
    chunks, linear_hash, versioned_hash, _ = wit
    x = int.from_bytes(keccak256(linear_hash + versioned_hash)[16:],
                       "big") % kzg.R
    elements = [int.from_bytes(c, "little") for c in chunks]
    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    with ly.engine_override(cfg):
        sd, _prog = ly.create_eip4844_setup_data(16, limb_bits=8)
        proof = ly.prove_eip4844(elements, x, n_elements=16, limb_bits=8)
        assert ly.verify_eip4844(elements, x, proof, n_elements=16,
                                 limb_bits=8)
    _write_plonkish("eip4844_n16", sd.vk, proof)
    _write_json("eip4844_golden.json", dict(
        blob=BLOB.hex(), x=x, elements=elements,
        witness=convert.eip4844_witness_to_json(wit),
        settings=dict(
            domain_size=settings.domain_size,
            roots_of_unity=settings.roots_of_unity,
            g1_lagrange_brp=[list(p) for p in settings.g1_lagrange_brp],
            setup_g2_1=[list(c) for c in settings.setup_g2_1])))


def stage_chain():
    from zkevm_harness_tpu import full_chain as fc
    from zkevm_harness_tpu.circuits import scheduler_circuit as sc_circ
    from zkevm_harness_tpu.vm import isa
    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    chain = fc.prove_block_full_chain(
        golden.tower_block(isa), chain_types=(8,), base_cfg=cfg,
        recursion_cfg=cfg, blobs=[BLOB],
        blob_kzg_settings=kzg.KzgSettings.testing(16))
    _write_plonkish("wrap_blob_scheduler", chain.scheduler.vk,
                    chain.scheduler.proof)
    _write_plonkish("wrap_blob_mode1", chain.final["final_vk"],
                    chain.final["final_proof"])
    _write_json("wrap_blob_snark_pi_proof.json",
                convert.plonk_proof_to_json(chain.snark["proof"]))
    _write_json("wrap_blob_summary.json", dict(
        aux_values=[int(v) for v in sc_circ.scheduler_aux_values(
            chain.block.scheduler_witness)],
        scheduler_pi=[int(v) for v in chain.scheduler_pi],
        snark_public_input=str(chain.final["snark_public_input"])))


STAGES = {"standin": stage_standin, "mode1": stage_mode1,
          "snark": stage_snark, "eip4844": stage_eip4844,
          "chain": stage_chain}


def main():
    names = sys.argv[1:] or list(STAGES)
    for name in names:
        t0 = time.time()
        STAGES[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
