"""Write the golden artifacts of the hash circuits:
`test_artifacts/{keccak_log7,sha256_log8,hasher_log7,decommitter_log8,
decommitts_log8}_{vk,proof}.json`.

    JAX_PLATFORMS=cpu python tools/gen_hash_golden.py

The small hash block of `zkevm_harness_tpu_torch/golden.py`
(`golden.HASH_GOLDEN`: 2 rounds of keccak and SHA-256 precompile calls, an
L1 message and a far call to the one deployed callee) runs through the JAX
package's out-of-circuit VM with a `WitnessTracer`. Its keccak calls feed
the keccak round-function circuit (type 5), its SHA-256 calls the SHA-256
one (type 6), its deduplicated L1 messages the L1-messages hasher (type 13),
its fresh decommitments and decommitted bytecodes the code decommitter
(type 3), and all its decommitment queries the decommitments sorter
(type 2). Each decomposer works at the capacity `golden.HASH_CAPACITY`
names; the first instance of each is set up, proved and verified by the JAX
package's typed layer functions (`prover/layers.py`) with the golden prover
config (rate 2, cap 4, 4 queries, final FRI size 8). The PyTorch port is
held against the ten files: its VK and proof of the same instance must be
equal to them value for value. Rerun only after an intentional protocol
change.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

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
from zkevm_harness_tpu.witness.decommitter import \
    compute_code_decommitter_artifacts  # noqa: E402
from zkevm_harness_tpu.witness.linear_hasher import \
    compute_hasher_circuit_artifacts  # noqa: E402
from zkevm_harness_tpu.witness.precompile_circuits import (  # noqa: E402
    compute_keccak_circuit_artifacts, compute_sha256_circuit_artifacts)
from zkevm_harness_tpu.witness.sorters import \
    compute_decommitts_circuit_artifacts  # noqa: E402
from zkevm_harness_tpu.witness.tracer import WitnessTracer  # noqa: E402
from zkevm_harness_tpu_torch import golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def trace_hash_block(rounds, call_every, callee_reps):
    """The hash block traced by the JAX package's VM, its callees deployed
    by the JAX package's `deploy_contract`."""
    prog = golden.hash_block(isa, rounds, call_every, callee_reps)
    limit = 8 * len(prog) + 64
    tracer = WitnessTracer(limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=testing_geometry())
    for address, code in golden.hash_callees(isa, callee_reps):
        deploy_contract(tools, address, code)
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    run_vm(vm, prog, limit)
    assert vm.finished
    return tracer


def _write(name, log_n, setup_data, proof):
    with open(os.path.join(OUT, f"{name}_log{log_n}_vk.json"), "w") as f:
        json.dump([int(v) for v in setup_data.vk], f)
    with open(os.path.join(OUT, f"{name}_log{log_n}_proof.json"), "w") as f:
        json.dump(serde.proof_to_json(proof), f)


def main():
    t0 = time.time()
    tracer = trace_hash_block(**golden.HASH_GOLDEN)
    cap = golden.HASH_CAPACITY
    calls = {a: [d for (_, q, d, _r) in tracer.precompile_calls
                 if q.address == a]
             for a in (golden.KECCAK_ADDRESS, golden.SHA256_ADDRESS)}
    l1 = oracle.dedup_events(
        [q for _, q in oracle.demux_log_queue(tracer.final_log_queue())["l1"]])
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    with ly.engine_override(cfg):
        art = compute_keccak_circuit_artifacts(
            calls[golden.KECCAK_ADDRESS], cap["keccak"])
        inst, cg = art.instances[0], (art.challenges, art.gammas)
        proof = ly.prove_keccak_instance(inst, cg, cap["keccak"])
        assert ly.verify_keccak_instance(inst, cg, cap["keccak"], proof)
        sd, geo = ly.keccak_setup_data(cap["keccak"])
        _write("keccak", geo.log_n, sd, proof)
        print(f"keccak written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_sha256_circuit_artifacts(
            calls[golden.SHA256_ADDRESS], cap["sha256"])
        inst, cg = art.instances[0], (art.challenges, art.gammas)
        proof = ly.prove_sha256_instance(inst, cg, cap["sha256"])
        assert ly.verify_sha256_instance(inst, cg, cap["sha256"], proof)
        sd, geo = ly.sha256_setup_data(cap["sha256"])
        _write("sha256", geo.log_n, sd, proof)
        print(f"sha256 written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_hasher_circuit_artifacts(l1, cap["hasher"])
        inst = art.instances[0]
        proof = ly.prove_hasher_instance(inst, cap["hasher"])
        assert ly.verify_hasher_instance(inst, cap["hasher"], proof)
        sd, geo = ly.hasher_setup_data(cap["hasher"])
        _write("hasher", geo.log_n, sd, proof)
        print(f"hasher written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_code_decommitter_artifacts(
            [q for _, q in tracer.decommittment_queries if q.is_fresh],
            tracer.decommitted_bytecodes)
        inst = art.instances[0]
        proof = ly.prove_code_decommitter_instance(inst, cap["decommitter"])
        assert ly.verify_code_decommitter_instance(inst, cap["decommitter"],
                                                   proof)
        sd, geo = ly.code_decommitter_setup_data(cap["decommitter"])
        _write("decommitter", geo.log_n, sd, proof)
        print(f"decommitter written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_decommitts_circuit_artifacts(
            [q for _, q in tracer.decommittment_queries], cap["decommitts"])
        inst = art.instances[0]
        proof = ly.prove_decommitts_instance(inst, art.challenges,
                                             cap["decommitts"])
        assert ly.verify_decommitts_instance(inst, art.challenges,
                                             cap["decommitts"], proof)
        sd, geo = ly.decommitts_setup_data(cap["decommitts"])
        _write("decommitts", geo.log_n, sd, proof)
    print(f"golden hash-circuit artifacts written ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
