"""Write the golden artifacts of the block's memory and log circuits:
`test_artifacts/{ram,events,storage,demux}_log8_{vk,proof}.json`.

    JAX_PLATFORMS=cpu python tools/gen_sorter_golden.py

The fixed 200-cycle block of `zkevm_harness_tpu_torch/golden.py` runs
through the JAX package's out-of-circuit VM with a `WitnessTracer`. Its
memory queries feed the RAM permutation (type 8), its log queue the log
demuxer (type 4), its storage queries the storage sorter (type 9) and its
events the events sorter (type 11). Each decomposer splits its queue at the
capacity `golden.SORTER_CAPACITY` names; the first instance of each is set
up, proved and verified by the JAX package's typed layer functions
(`prover/layers.py`) with the golden prover config (rate 2, cap 4, 4
queries, final FRI size 8). The PyTorch port is held against the eight
files: its VK and proof of the same instance must be equal to them value
for value. Rerun only after an intentional protocol change.
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
from zkevm_harness_tpu.vm.interpreter import run_vm  # noqa: E402
from zkevm_harness_tpu.vm.state import (BlockProperties,  # noqa: E402
                                        ProvingToolset, create_vm)
from zkevm_harness_tpu.witness import oracle  # noqa: E402
from zkevm_harness_tpu.witness.log_demux import \
    compute_log_demux_artifacts  # noqa: E402
from zkevm_harness_tpu.witness.ram_permutation import \
    compute_ram_circuit_snapshots  # noqa: E402
from zkevm_harness_tpu.witness.sorters import (  # noqa: E402
    compute_events_circuit_artifacts, compute_storage_circuit_artifacts)
from zkevm_harness_tpu.witness.tracer import WitnessTracer  # noqa: E402
from zkevm_harness_tpu_torch import golden  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def _write(name, setup_data, proof):
    with open(os.path.join(OUT, f"{name}_log8_vk.json"), "w") as f:
        json.dump([int(v) for v in setup_data.vk], f)
    with open(os.path.join(OUT, f"{name}_log8_proof.json"), "w") as f:
        json.dump(serde.proof_to_json(proof), f)


def main():
    t0 = time.time()
    tracer = WitnessTracer(1000)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=testing_geometry())
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    cycles = run_vm(vm, golden.main_vm_block(isa), 1000)
    assert vm.finished and cycles == golden.MAIN_VM_CYCLES, cycles
    log = [q for _, q in tracer.final_log_queue()]
    demuxed = oracle.demux_log_queue(tracer.final_log_queue())
    cap = golden.SORTER_CAPACITY
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    with ly.engine_override(cfg):
        art = compute_ram_circuit_snapshots(
            [q for _, q in tracer.memory_queries], cap["ram"])
        inst = art.instances[0]
        proof = ly.prove_ram_instance(inst, art.challenges, cap["ram"])
        assert ly.verify_ram_instance(inst, art.challenges, cap["ram"], proof)
        _write("ram", ly.ram_setup_data(cap["ram"])[0], proof)
        print(f"ram written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_events_circuit_artifacts(
            [q for _, q in demuxed["events"]], cap["events"], circuit_type=11)
        inst = art.instances[0]
        proof = ly.prove_events_instance(inst, art.challenges, cap["events"])
        assert ly.verify_events_instance(inst, art.challenges, cap["events"],
                                         proof)
        _write("events", ly.events_setup_data(cap["events"])[0], proof)
        print(f"events written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_storage_circuit_artifacts(
            [q for _, q in demuxed["storage"]], cap["storage"])
        inst = art.instances[0]
        proof = ly.prove_storage_instance(inst, art.challenges,
                                          cap["storage"])
        assert ly.verify_storage_instance(inst, art.challenges,
                                          cap["storage"], proof)
        _write("storage", ly.storage_setup_data(cap["storage"])[0], proof)
        print(f"storage written ({time.time() - t0:.0f} s)", flush=True)

        art = compute_log_demux_artifacts(log, cap["demux"])
        inst = art.instances[0]
        proof = ly.prove_demux_instance(inst, cap["demux"])
        assert ly.verify_demux_instance(inst, cap["demux"], proof)
        _write("demux", ly.demux_setup_data(cap["demux"])[0], proof)
    print(f"golden memory and log artifacts written "
          f"({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
