"""Run `chip_smoke.py`'s proving-across-cards phases alone: `mesh_golden`,
`mesh_dryrun` and `mesh`, after the one-card prove of the main path's
flagship that phase `mesh` holds the sharded proof against.

    python3 tools/mesh_phases.py [--log-n 19] [--out FILE]

On a machine with one card every rank shares it over gloo; with at least
four cards each rank gets its own over NCCL. Prints the card's name and
power limit, the torch version and the card count, then one JSON object a
phase; with --out, also writes the phase records to FILE.
"""

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=19,
                    help="rows of the flagship as a power of two")
    ap.add_argument("--out", default=None,
                    help="also write the phase records to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device available", file=sys.stderr)
        return 1
    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils.kernel_bench import nvidia_smi_line

    print(nvidia_smi_line(), torch.__version__, torch.cuda.device_count(),
          flush=True)
    t0 = time.time()
    print("build_s", ck.build_all(force=True), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log_n = args.log_n
    cfg = pk.PlonkishConfig(rate=2, cap_size=16, num_queries=40,
                            final_fri_size=512)
    ir = fl.flagship_ir(log_n=log_n, width=cs.WIDTH)
    setup = fl.flagship_setup(ir, cfg, device=dev)
    witness = fl.flagship_witness(ir, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    proof = pk.prove(ir, setup, witness, cfg, device=dev)
    torch.cuda.synchronize()
    print("one_card_prove_s", time.time() - t1, flush=True)
    del witness
    records = []

    def phase(name, **fields):
        records.append({"phase": name, **fields})
        print(json.dumps(records[-1]), flush=True)

    launches = cs.mesh_phases(types.SimpleNamespace(log_n=log_n), dev, phase,
                              ir, setup.vk(), cfg, proof)
    print("launches", launches, "total_s", time.time() - t0, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
