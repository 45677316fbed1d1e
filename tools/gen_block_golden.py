"""Write the golden artifacts of the ecrecover (7) and storage-application
(10) circuits and of the whole block, with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_block_golden.py [stage ...]

Stages (all by default, in this order):
  ecrecover      test_artifacts/ecrecover_toy_{vk,proof}.json: the recovery
                 equation on the toy curve of `golden.ecrecover_toy_curve`
                 (61-bit field, 64-bit scalars, u8 limbs) for
                 `golden.ecrecover_toy_signature`;
  storage_app    test_artifacts/storage_app_d4_{vk,proof}.json: the depth-4
                 Blake2s path of `golden.STORAGE_APP_*`;
  block          test_artifacts/whole_block_golden.json: the whole block at
                 `golden.WHOLE_GOLDEN`, traced by the JAX package's VM, run
                 through its `create_artifacts_from_tracer` at
                 `testing_geometry()`, and summarised by
                 `convert.block_artifacts_summary`;
  vk7, vk10      test_artifacts/vk_{7,10}_production.json: the production
                 VKs (secp256k1 at u8 limbs, 286 x 2^16; depth 256,
                 2,609 x 2^12) at the base-layer config.

Both golden proofs use the golden prover config (rate 2, cap 4, 4 queries,
final FRI size 8) and are verified before they are written. Each stage
prints its seconds. The PyTorch port is held against these files value for
value. Rerun only after an intentional protocol change.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from zkevm_harness_tpu.circuits import ecrecover_circuit as ecc  # noqa: E402
from zkevm_harness_tpu.circuits import ffarith as ff  # noqa: E402
from zkevm_harness_tpu.circuits import \
    storage_application_circuit as sac  # noqa: E402
from zkevm_harness_tpu.circuits.types import testing_geometry  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.vm import isa  # noqa: E402
from zkevm_harness_tpu.vm.environment import (  # noqa: E402
    DefaultPrecompilesProcessor, InMemoryEventSink, InMemoryStorage,
    SimpleDecommitter, SimpleMemory)
from zkevm_harness_tpu.vm.interpreter import (deploy_contract,  # noqa: E402
                                              run_vm)
from zkevm_harness_tpu.vm.state import (BlockProperties,  # noqa: E402
                                        ProvingToolset, create_vm)
from zkevm_harness_tpu.witness import oracle  # noqa: E402
from zkevm_harness_tpu.witness.tracer import WitnessTracer  # noqa: E402
from zkevm_harness_tpu_torch import convert, golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
CFG = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)


def trace_whole_block(rounds, call_every, callee_reps, ecrecover_calls):
    """(tracer, pre-state) of the whole block run by the JAX package's VM,
    its callees deployed by the JAX package's `deploy_contract`."""
    prog = golden.whole_block(isa, rounds, call_every, callee_reps,
                              ecrecover_calls)
    limit = 8 * len(prog) + 64
    tracer = WitnessTracer(limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=testing_geometry())
    for address, code in golden.hash_callees(isa, callee_reps):
        deploy_contract(tools, address, code)
    pre_state = dict(tools.storage.inner)
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    run_vm(vm, prog, limit)
    assert vm.finished
    return tracer, pre_state


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def _write(name, vk, proof):
    _write_json(f"{name}_vk.json", [int(v) for v in vk])
    _write_json(f"{name}_proof.json", serde.proof_to_json(proof))


def stage_ecrecover():
    eprog = ecc.build_ecrecover_program(
        ecc.CurveParams(**golden.ecrecover_toy_curve()))
    ir, setup = ff.ff_setup(eprog.layout, CFG)
    h, r, s, q, ry = golden.ecrecover_toy_signature()
    proof = pk.prove(ir, setup, ecc.ecrecover_witness(eprog, ir, h, r, s, q,
                                                      ry), CFG)
    assert [int(v) for v in proof.public_inputs] == \
        [int(v) % pk.gl.P
         for v in ecc.expected_public_inputs(eprog, h, r, s, q)]
    assert pk.verify(ir, setup.vk(), proof, CFG)
    _write("ecrecover_toy", setup.vk(), proof)


def stage_storage_app():
    inst = sac.PathInstanceInputs(
        leaf_preimage=golden.STORAGE_APP_LEAF,
        path_bits=list(golden.STORAGE_APP_PATH_BITS),
        siblings=list(golden.STORAGE_APP_SIBLINGS))
    with ly.engine_override(CFG):
        proof = ly.prove_storage_application_path(inst)
        assert ly.verify_storage_application_path(inst, proof)
        sd, _geo = ly.storage_application_setup_data(
            depth=golden.STORAGE_APP_DEPTH)
    _write(f"storage_app_d{golden.STORAGE_APP_DEPTH}", sd.vk, proof)


def stage_block():
    tracer, pre = trace_whole_block(**golden.WHOLE_GOLDEN)
    geo = testing_geometry()
    art = oracle.create_artifacts_from_tracer(tracer, geo,
                                              initial_storage=pre)
    summary = convert.block_artifacts_summary(
        art, geo, ly.real_base_instance_public_inputs)
    summary["cycles"] = tracer.cycle_counter
    _write_json("whole_block_golden.json", summary)


def stage_vk7():
    sd, eprog = ly.ecrecover_setup_data()
    print(f"  type 7: {sd.ir.num_witness} x 2^{sd.ir.log_n}, "
          f"{eprog.layout.num_rows} rows", flush=True)
    _write_json("vk_7_production.json", [int(v) for v in sd.vk])


def stage_vk10():
    sd, geo = ly.storage_application_setup_data(depth=256)
    print(f"  type 10: {sd.ir.num_witness} x 2^{sd.ir.log_n}", flush=True)
    _write_json("vk_10_production.json", [int(v) for v in sd.vk])


STAGES = {"ecrecover": stage_ecrecover, "storage_app": stage_storage_app,
          "block": stage_block, "vk7": stage_vk7, "vk10": stage_vk10}


def main():
    for name in sys.argv[1:] or list(STAGES):
        t0 = time.time()
        STAGES[name]()
        print(f"{name} written ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
