"""Count the field-kernel launches of one prove of the ecrecover (7) and
storage-application (10) circuits at their production widths, on the CPU.

    python tools/count_block_launches.py

Type 7 is taken at its production columns and constraints (secp256k1 at u8
limbs: 286 witness columns, 286 lookup sets on the 2^8 range table) with a
short program of foreign-field rows at the smallest row count its table
allows (2^8); type 10 at depth 4 (2^6 rows), whose columns and constraints
are those of depth 256. Each is proved once with 50 queries, witness fill
included, as `prove_ecrecover_invocation` / `prove_storage_application_path`
run them. On the CPU the kernel wrappers run their plain versions and count
nothing, so the plain versions' calls are counted instead, as
tools/count_hash_launches.py does: one call is one launch on the card. The
constraint evaluation is one launch per operation over a whole coset
whatever the row count; the NTT, Merkle and FRI loops grow with the rows.
Prints one JSON line per circuit.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from count_hash_launches import COUNTS, SHAPES  # noqa: E402  (counts calls)

from zkevm_harness_tpu_torch import golden  # noqa: E402
from zkevm_harness_tpu_torch.circuits import ecrecover_circuit as ecc  # noqa: E402
from zkevm_harness_tpu_torch.circuits import ffarith as ff  # noqa: E402
from zkevm_harness_tpu_torch.circuits import \
    storage_application_circuit as sac  # noqa: E402
from zkevm_harness_tpu_torch.prover import plonkish as pk  # noqa: E402


def ff_case():
    """A few rows of every kind at secp256k1 / u8 limbs."""
    par = ff.FFParams(modulus=ecc.SECP_P, limb_bits=8, num_limbs=32)
    prog = ff.FFProgram(par)
    x, y = prog.input(), prog.input()
    b = prog.boolean()
    acc = prog.mul(x, y)
    for _ in range(8):
        acc = prog.fma(acc, y, x)
        acc = prog.add_const(prog.mul_const(acc, 3), 7)
    prog.fma(b, acc, x)
    layout = ff.build_ff_layout(prog, public_results=(acc,))
    inputs = {(x.row, "A"): 0x1234567 ** 9 % ecc.SECP_P,
              (y.row, "A"): 0xABCDEF ** 11 % ecc.SECP_P, (b.row, "A"): 1}
    return layout, inputs


def main():
    dev = "cpu"
    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=50,
                            final_fri_size=8)
    layout, inputs = ff_case()
    ir7 = ff.layout_ir(layout)
    geo10 = sac.PathGeometry(depth=golden.STORAGE_APP_DEPTH)
    ir10 = sac.path_ir(geo10)
    inst10 = sac.PathInstanceInputs(
        golden.STORAGE_APP_LEAF, list(golden.STORAGE_APP_PATH_BITS),
        list(golden.STORAGE_APP_SIBLINGS))
    cases = [
        ("ecrecover", ir7, 16, lambda: ff.ff_setup(layout, cfg, dev)[1],
         lambda: ff.ff_witness(layout, ir7, inputs, device=dev)),
        ("storage_application", ir10, 12,
         lambda: sac.path_setup(ir10, geo10, cfg, dev),
         lambda: sac.path_witness(ir10, geo10, inst10, dev))]
    for name, ir, prod_log_n, make_setup, make_witness in cases:
        setup = make_setup()
        COUNTS.clear()
        SHAPES.clear()
        t0 = time.time()
        pk.prove(ir, setup, make_witness(), cfg, device=dev)
        print(json.dumps({"circuit": name, "log_n": ir.log_n,
                          "production_log_n": prod_log_n,
                          "width": ir.num_witness,
                          "gate_constraints": ir.num_gate_constraints,
                          "lookup_sets": len(ir.lookup_sets),
                          "launches": dict(sorted(COUNTS.items())),
                          "total": sum(COUNTS.values()),
                          "top_shapes": {k: [[list(s), c] for s, c in
                                             v.most_common(3)]
                                         for k, v in SHAPES.items()},
                          "cpu_s": round(time.time() - t0, 1)}), flush=True)
        del setup


if __name__ == "__main__":
    main()
