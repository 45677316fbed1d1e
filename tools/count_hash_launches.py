"""Count the field-kernel launches of one typed prove of each hash circuit
at its production width, on the CPU, and the shapes they run at.

    python tools/count_hash_launches.py

The keccak (5), SHA-256 (6), L1-messages hasher (13) and code decommitter
(3) circuits have the same columns and constraints at every row count; the
decommitments sorter (2) is set up with its production tile count (29 per
strip, `GeometryConfig()` capacity through `prover/layers.py`). Each is
taken at the smallest row count of the golden artifacts (2^7 or 2^8) with
the golden hash block's first instance (`zkevm_harness_tpu_torch/golden.py`)
and proved once with 50 queries: witness fill plus prove, as
`prove_*_instance` runs them. On the CPU the kernel wrappers run their plain
versions and count nothing, so this script counts the calls of the plain
versions instead: one call is one launch on the card. The constraint
evaluation is one launch per operation over a whole coset whatever the row
count; the NTT, Merkle and FRI loops grow with the rows. Prints one JSON
line per circuit: launches per kernel, and the most frequent shapes (the
row axis scaled to the production row count, where it is a multiple of the
row count of this run).
"""

import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zkevm_harness_tpu_torch import golden  # noqa: E402
from zkevm_harness_tpu_torch.circuits import decommitter_circuit as cdc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import decommitts_sorter_circuit as dsc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import keccak_circuit as kc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import linear_hasher_circuit as lhc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import sha256_circuit as shc  # noqa: E402
from zkevm_harness_tpu_torch.circuits.types import GeometryConfig  # noqa: E402
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zkevm_harness_tpu_torch.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu_torch.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu_torch.witness import oracle  # noqa: E402
from zkevm_harness_tpu_torch.witness.decommitter import \
    compute_code_decommitter_artifacts  # noqa: E402
from zkevm_harness_tpu_torch.witness.linear_hasher import \
    compute_hasher_circuit_artifacts  # noqa: E402
from zkevm_harness_tpu_torch.witness.precompile_circuits import (  # noqa: E402
    compute_keccak_circuit_artifacts, compute_sha256_circuit_artifacts)
from zkevm_harness_tpu_torch.witness.sorters import \
    compute_decommitts_circuit_artifacts  # noqa: E402

COUNTS = collections.Counter()
SHAPES = collections.defaultdict(collections.Counter)
_DEPTH = [0]


def _counted(name, fn):
    """fn, counting its outermost calls only (a plain version that calls
    another is one launch), with the shape of what it returns."""
    def wrapper(*args):
        top = _DEPTH[0] == 0
        _DEPTH[0] += 1
        try:
            out = fn(*args)
        finally:
            _DEPTH[0] -= 1
        if top:
            COUNTS[name] += 1
            SHAPES[name][tuple(out.shape)] += 1
        return out
    return wrapper


for _name in ("gl_mul", "gl_add", "gl_sub", "gl_pow7"):
    setattr(ck, _name + "_plain", _counted(_name, getattr(ck, _name + "_plain")))
ck.poseidon2_permute_plain = _counted("poseidon2_permute",
                                      ck.poseidon2_permute_plain)
ck.poseidon2_permute_one_host = _counted("poseidon2_permute",
                                         ck.poseidon2_permute_one_host)


def _scaled(shape, n, n_prod):
    """The shape at the production rows: the row axis (the last, or the
    first of a batch of Poseidon2 states) scaled where it is a multiple of
    n (a coset, the trace or its commitment domain)."""
    axis = 0 if len(shape) > 1 and shape[-1] == 12 else len(shape) - 1
    shape = list(shape)
    if shape and shape[axis] >= n and shape[axis] % n == 0:
        shape[axis] = shape[axis] * n_prod // n
    return tuple(shape)


def main():
    dev = "cpu"
    g = GeometryConfig()
    tracer = golden.trace_hash_block(**golden.HASH_GOLDEN)
    calls = {a: [d for (_, q, d, _r) in tracer.precompile_calls
                 if q.address == a]
             for a in (golden.KECCAK_ADDRESS, golden.SHA256_ADDRESS)}
    l1 = oracle.dedup_events([q for _, q in oracle.demux_log_queue(
        tracer.final_log_queue())["l1"]])
    queries = [q for _, q in tracer.decommittment_queries]
    cap = golden.HASH_CAPACITY
    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=50,
                            final_fri_size=8)
    prod_log_n = {
        "keccak": ly.keccak_geometry_for_capacity(
            g.cycles_per_keccak256_circuit).log_n,
        "sha256": ly.sha256_geometry_for_capacity(
            g.cycles_per_sha256_circuit).log_n,
        "hasher": ly.hasher_geometry_for_capacity(
            g.limit_for_l1_messages_pudata_hasher).log_n,
        "decommitter": ly.code_decommitter_geometry_for_capacity(
            g.cycles_per_code_decommitter).log_n,
        "decommitts": ly.decommitts_geometry_for_capacity(
            g.cycles_per_code_decommitter_sorter).log_n}

    cases = []
    art = compute_keccak_circuit_artifacts(calls[golden.KECCAK_ADDRESS],
                                           cap["keccak"], device=dev)
    geo = ly.keccak_geometry_for_capacity(cap["keccak"])
    inst = art.instances[0]
    pay = kc.instance_inputs(inst.invocations, art.challenges, art.gammas,
                             inst.acc_in, inst.cnt_in)
    ir = kc.keccak_ir(geo.log_n)
    cases.append(("keccak", ir, lambda ir=ir, geo=geo: kc.keccak_setup(
        ir, geo, cfg, dev), lambda ir=ir, geo=geo, pay=pay: kc.keccak_witness(
            ir, geo, pay, dev)))
    art = compute_sha256_circuit_artifacts(calls[golden.SHA256_ADDRESS],
                                           cap["sha256"], device=dev)
    geo = ly.sha256_geometry_for_capacity(cap["sha256"])
    inst = art.instances[0]
    pay = shc.instance_inputs(inst.invocations, art.challenges, art.gammas,
                              inst.acc_in, inst.cnt_in)
    ir = shc.sha256_ir(geo.log_n)
    cases.append(("sha256", ir, lambda ir=ir, geo=geo: shc.sha256_setup(
        ir, geo, cfg, dev), lambda ir=ir, geo=geo, pay=pay: shc.sha256_witness(
            ir, geo, pay, dev)))
    art = compute_hasher_circuit_artifacts(l1, cap["hasher"], device=dev)
    geo = ly.hasher_geometry_for_capacity(cap["hasher"])
    ir = lhc.hasher_ir(geo.log_n)
    cases.append(("hasher", ir, lambda ir=ir, geo=geo: lhc.hasher_setup(
        ir, geo, cfg, dev), lambda ir=ir, geo=geo, art=art: lhc.hasher_witness(
            ir, geo, art.instances[0], dev)))
    art = compute_code_decommitter_artifacts(
        [q for q in queries if q.is_fresh], tracer.decommitted_bytecodes,
        device=dev)
    geo = ly.code_decommitter_geometry_for_capacity(cap["decommitter"])
    ir = cdc.decommitter_ir(geo.log_n)
    cases.append(("decommitter", ir,
                  lambda ir=ir, geo=geo: cdc.decommitter_setup(
                      ir, geo, cfg, dev),
                  lambda ir=ir, geo=geo, art=art: cdc.decommitter_witness(
                      ir, geo, art.instances[0], dev)))
    # the production tile count (29 per strip) at 2^8 rows
    tiles = ly.decommitts_geometry_for_capacity(
        g.cycles_per_code_decommitter_sorter).tiles_per_queue
    geo = dsc.DecommittsGeometry(8, tiles)
    art = compute_decommitts_circuit_artifacts(queries, geo.capacity,
                                               device=dev)
    ir = dsc.decommitts_ir(geo.log_n, tiles)
    cases.append(("decommitts", ir,
                  lambda ir=ir, geo=geo: dsc.decommitts_setup(
                      ir, geo, cfg, dev),
                  lambda ir=ir, geo=geo, art=art: dsc.decommitts_witness(
                      ir, geo, dsc.instance_inputs(art.instances[0],
                                                   art.challenges), dev)))

    for name, ir, make_setup, make_witness in cases:
        setup = make_setup()
        COUNTS.clear()
        SHAPES.clear()
        t0 = time.time()
        witness = make_witness()
        pk.prove(ir, setup, witness, cfg, device=dev)
        n, n_prod = 1 << ir.log_n, 1 << prod_log_n[name]
        top = {}
        for kern, shapes in SHAPES.items():
            merged = collections.Counter()
            for shape, k in shapes.items():
                merged[_scaled(shape, n, n_prod)] += k
            top[kern] = [[list(s), k] for s, k in merged.most_common(5)]
        print(json.dumps({"circuit": name, "log_n": ir.log_n,
                          "production_log_n": prod_log_n[name],
                          "width": ir.num_witness,
                          "gate_constraints": ir.num_gate_constraints,
                          "launches": dict(sorted(COUNTS.items())),
                          "total": sum(COUNTS.values()),
                          "top_shapes": top,
                          "cpu_s": round(time.time() - t0, 1)}), flush=True)
        del setup, witness


if __name__ == "__main__":
    main()
