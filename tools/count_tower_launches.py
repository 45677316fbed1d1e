"""The recursion tower's outer circuits on the CPU: the production leaves'
shapes, and the field-kernel launches of one leaf fill and prove.

    python tools/count_tower_launches.py [shapes] [launches]

shapes    synthesizes and finalizes the leaf (arity 1) over the production
          IRs of the RAM permutation (8, 599 x 2^18) and ecrecover (7,
          secp256k1 at u8 limbs, 286 x 2^16) at the production config
          (rate 2, cap 16, 50 queries, final FRI size 512), as
          `harness.run_block(tower=True)` does, and prints each leaf's
          gates, permutations, rows and columns, moved copy cells, the
          rounds of its evaluation schedule (`CircuitBuilder._schedule`:
          the permutations of a round are batched on the card), and the
          host seconds of synthesis, finalize and scheduling on this
          machine.
launches  fills and proves a leaf (arity 1) over the golden flagship proof
          (`test_artifacts/flagship_log6_proof.json`) with 50 queries on
          the CPU and counts the calls of the kernels' plain versions, as
          tools/count_hash_launches.py does: one call is one launch on the
          card. The builder's gates evaluate as stacked tensors, so a
          coset's launches do not grow with the slots or the tiles; the
          NTT, Merkle and FRI loops grow with the rows.

Prints one JSON line per circuit.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from count_hash_launches import COUNTS, SHAPES  # noqa: E402  (counts calls)

from zkevm_harness_tpu_torch import convert  # noqa: E402
from zkevm_harness_tpu_torch.circuits import ffarith as ff  # noqa: E402
from zkevm_harness_tpu_torch.circuits import flagship as fl  # noqa: E402
from zkevm_harness_tpu_torch.circuits import leaf_circuit as lc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import \
    ram_permutation_circuit as rc  # noqa: E402
from zkevm_harness_tpu_torch.circuits.types import (  # noqa: E402
    GeometryConfig, base_capacity)
from zkevm_harness_tpu_torch.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu_torch.prover import plonkish as pk  # noqa: E402

CFG = pk.PlonkishConfig(rate=2, cap_size=16, num_queries=50,
                        final_fri_size=512)
ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def shapes():
    geo = GeometryConfig()
    g8 = ly.ram_geometry_for_capacity(base_capacity(geo, 8))
    inner = {8: lambda: rc.ram_ir(g8.log_n, g8.tiles_per_queue),
             7: lambda: ff.layout_ir(ly._ecrecover_program().layout)}
    for ctype, make_ir in inner.items():
        ir = make_ir()
        t0 = time.time()
        b, _ = lc.synthesize_leaf(ir, CFG, 1, ctype)
        t1 = time.time()
        built = b.finalize()
        t2 = time.time()
        rounds = b._schedule()
        t3 = time.time()
        print(json.dumps({
            "circuit": f"leaf {ctype}", "inner": [ir.log_n, ir.num_witness],
            "log_n": built.ir.log_n, "width": built.ir.num_witness,
            "gates": b.num_gates, "permutations": len(b.perms),
            "ops": len(b.ops), "moved_cells": len(built.wiring.cells),
            "public_inputs": len(built.ir.public_input_cells),
            "cpu_synthesis_s": round(t1 - t0, 2),
            "cpu_finalize_s": round(t2 - t1, 2),
            "evaluation_rounds": len(rounds),
            "largest_round_permutations": max(len(p) for _, p in rounds),
            "cpu_schedule_s": round(t3 - t2, 2)}), flush=True)


def launches():
    with open(os.path.join(ART, "flagship_log6_proof.json")) as f:
        proof = convert.proof_from_json(json.load(f))
    with open(os.path.join(ART, "flagship_log6_vk.json")) as f:
        vk = json.load(f)
    inner_cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=8,
                                  final_fri_size=8)
    b, lay = lc.synthesize_leaf(fl.flagship_ir(log_n=6, width=8), inner_cfg,
                                1, 8)
    built = b.finalize()
    setup = built.setup(CFG, device="cpu")
    asg = lc.leaf_assignments(lay, vk, [proof])
    COUNTS.clear()
    SHAPES.clear()
    t0 = time.time()
    W = b.fill_witness(asg, device="cpu")
    pk.prove(built.ir, setup, W, CFG, device="cpu")
    print(json.dumps({"circuit": "leaf over the golden flagship proof",
                      "log_n": built.ir.log_n,
                      "width": built.ir.num_witness, "gates": b.num_gates,
                      "tiles": b.tiles,
                      "launches": dict(sorted(COUNTS.items())),
                      "total": sum(COUNTS.values()),
                      "top_shapes": {k: [[list(s), c] for s, c in
                                         v.most_common(3)]
                                     for k, v in SHAPES.items()},
                      "cpu_s": round(time.time() - t0, 1)}), flush=True)


STAGES = {"shapes": shapes, "launches": launches}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(STAGES):
        STAGES[name]()
