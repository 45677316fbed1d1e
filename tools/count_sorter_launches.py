"""Count the field-kernel launches of one prove of each memory and log
circuit at its production width, on the CPU.

    python tools/count_sorter_launches.py [log_n ...]      # default 8 9

The RAM permutation, events sorter, storage sorter and log demuxer are set
up at their production tile counts (`GeometryConfig()` capacities through
`prover/layers.py`), so their widths and constraint lists are the
production ones, but at few rows (`log_n`); the first instance of the
golden block (`zkevm_harness_tpu_torch/golden.py`) at the geometry's
capacity is proved once with 50 queries. On the CPU the kernel wrappers
run their plain versions and count nothing, so this script counts the
calls of the plain versions instead: one call is one launch on the card.
Most of a prove's launches do not depend on the row count (the constraint
evaluation is one launch per operation over a whole coset); the NTT,
Merkle and FRI loops grow with log_n, so two row counts give the slope to
extrapolate to the production row count. Prints one JSON line per type and
row count.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zkevm_harness_tpu_torch import golden  # noqa: E402
from zkevm_harness_tpu_torch.circuits import events_sorter_circuit as ec  # noqa: E402
from zkevm_harness_tpu_torch.circuits import log_demux_circuit as dc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import ram_permutation_circuit as rc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import storage_sorter_circuit as sc  # noqa: E402
from zkevm_harness_tpu_torch.circuits.types import GeometryConfig  # noqa: E402
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zkevm_harness_tpu_torch.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu_torch.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu_torch.witness import oracle  # noqa: E402
from zkevm_harness_tpu_torch.witness.log_demux import \
    compute_log_demux_artifacts  # noqa: E402
from zkevm_harness_tpu_torch.witness.ram_permutation import \
    compute_ram_circuit_snapshots  # noqa: E402
from zkevm_harness_tpu_torch.witness.sorters import (  # noqa: E402
    compute_events_circuit_artifacts, compute_storage_circuit_artifacts)

COUNTS = {}
_DEPTH = [0]


def _counted(name, fn):
    """fn, counting its outermost calls only: a plain version that calls
    another (the plain permutation's field ops) is one launch."""
    def wrapper(*args):
        if _DEPTH[0] == 0:
            COUNTS[name] = COUNTS.get(name, 0) + 1
        _DEPTH[0] += 1
        try:
            return fn(*args)
        finally:
            _DEPTH[0] -= 1
    return wrapper


for _name in ("gl_mul", "gl_add", "gl_sub", "gl_pow7"):
    setattr(ck, _name + "_plain", _counted(_name, getattr(ck, _name + "_plain")))
ck.poseidon2_permute_plain = _counted("poseidon2_permute",
                                      ck.poseidon2_permute_plain)
ck.poseidon2_permute_one_host = _counted("poseidon2_permute",
                                         ck.poseidon2_permute_one_host)


def main():
    log_ns = [int(a) for a in sys.argv[1:]] or [8, 9]
    dev = "cpu"
    g = GeometryConfig()
    tracer = golden.trace_main_vm_block()
    demuxed = oracle.demux_log_queue(tracer.final_log_queue())
    mem = [q for _, q in tracer.memory_queries]
    log = [q for _, q in tracer.final_log_queue()]
    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=50,
                            final_fri_size=8)
    for log_n in log_ns:
        # production tile counts at log_n rows
        ram_geo = rc.RamGeometry(log_n, ly.ram_geometry_for_capacity(
            g.cycles_per_ram_permutation).tiles_per_queue)
        ev_geo = ec.EventsGeometry(log_n, ly.events_geometry_for_capacity(
            g.cycles_per_events_or_l1_messages_sorter).tiles)
        st_geo = sc.StorageGeometry(log_n, ly.storage_geometry_for_capacity(
            g.cycles_per_storage_sorter).tiles)
        dm_geo = dc.DemuxGeometry(log_n, ly.demux_geometry_for_capacity(
            g.cycles_per_log_demuxer).tiles)
        cases = []
        art = compute_ram_circuit_snapshots(mem, ram_geo.capacity, device=dev)
        ir = rc.ram_ir(log_n, ram_geo.tiles_per_queue)
        cases.append(("ram", ir, lambda: rc.ram_setup(ir, ram_geo, cfg, dev),
                      lambda ir=ir, art=art: rc.ram_witness(
                          ir, ram_geo, rc.instance_inputs(
                              art.instances[0], art.challenges), dev)))
        art = compute_events_circuit_artifacts(
            [q for _, q in demuxed["events"]], ev_geo.capacity, device=dev)
        ir2 = ec.events_ir(log_n, ev_geo.tiles)
        cases.append(("events", ir2,
                      lambda: ec.events_setup(ir2, ev_geo, cfg, dev),
                      lambda art=art: ec.events_witness(
                          ir2, ev_geo, ec.instance_inputs(
                              art.instances[0], art.challenges), dev)))
        art = compute_storage_circuit_artifacts(
            [q for _, q in demuxed["storage"]], st_geo.capacity, device=dev)
        ir3 = sc.storage_ir(log_n, st_geo.tiles)
        cases.append(("storage", ir3,
                      lambda: sc.storage_setup(ir3, st_geo, cfg, dev),
                      lambda art=art: sc.storage_witness(
                          ir3, st_geo, sc.instance_inputs(
                              art.instances[0], art.challenges), dev)))
        art = compute_log_demux_artifacts(log, dm_geo.capacity, device=dev)
        ir4 = dc.demux_ir(log_n, dm_geo.tiles)
        cases.append(("demux", ir4,
                      lambda: dc.demux_setup(ir4, dm_geo, cfg, dev),
                      lambda art=art: dc.demux_witness(
                          ir4, dm_geo, art.instances[0], dev)))
        for name, ir_, make_setup, make_witness in cases:
            setup = make_setup()
            witness = make_witness()
            COUNTS.clear()
            t0 = time.time()
            pk.prove(ir_, setup, witness, cfg, device=dev)
            print(json.dumps({"circuit": name, "log_n": log_n,
                              "width": ir_.num_witness,
                              "gate_constraints": ir_.num_gate_constraints,
                              "launches": dict(sorted(COUNTS.items())),
                              "total": sum(COUNTS.values()),
                              "cpu_s": round(time.time() - t0, 1)}),
                  flush=True)
            del setup, witness


if __name__ == "__main__":
    main()
