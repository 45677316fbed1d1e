"""One base type's production leaf on the card, step by step: what the
whole block's tower (`harness.run_block(tower=True)`) does for that type,
each step's seconds and the card's peak memory printed as it ends, so a
leaf too large for the card or the run shows where it stops.

    python3 tools/leaf_probe.py [--leaf-arity K] TYPE[:ARITY] [...]

For each type: the whole block (`golden.WHOLE_BLOCK`) through
`create_artifacts_from_tracer` at `GeometryConfig()`, the type's base
setup and its first ARITY instances proved and verified (ARITY defaults to
`--leaf-arity`, else to all of the block's instances, the leaf of
`RECURSION_ARITY` = 32), then, as the tower does, the base setup let go of
and the leaf over those proofs at `golden.TOWER_CONFIG`: synthesis,
finalize, setup, fill, prove (with the running peak at the end of each
prover stage, `plonkish.STAGE_PEAKS`), verify. One JSON line per step; a
step that fails ends the run with its error. Needs one CUDA card.
"""

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from zkevm_harness_tpu_torch import golden  # noqa: E402
from zkevm_harness_tpu_torch.circuits import leaf_circuit as lc  # noqa: E402
from zkevm_harness_tpu_torch.circuits.types import GeometryConfig  # noqa
from zkevm_harness_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zkevm_harness_tpu_torch.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu_torch.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu_torch.utils.kernel_bench import \
    nvidia_smi_line  # noqa: E402
from zkevm_harness_tpu_torch.witness import oracle  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaf-arity", type=int, default=None,
                    help="base proofs a leaf verifies, where TYPE gives "
                         "none (the tower's `leaf_arity`)")
    ap.add_argument("types", nargs="+", metavar="TYPE[:ARITY]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("leaf_probe: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = pk.PlonkishConfig(**golden.TOWER_CONFIG)
    geo = GeometryConfig()
    print(json.dumps({"nvidia_smi": nvidia_smi_line(),
                      "build_s": round(ck.build_all(), 3)}), flush=True)
    tracer, pre = golden.trace_whole_block(**golden.WHOLE_BLOCK)
    art = oracle.create_artifacts_from_tracer(tracer, geo,
                                              initial_storage=pre,
                                              device=dev)
    payloads = oracle.block_payloads(art, geo)
    for arg in args.types:
        ctype, _, arity = arg.partition(":")
        ctype = int(ctype)
        insts, ch, cap = payloads[ctype]
        arity = int(arity) if arity else min(
            args.leaf_arity or len(insts), len(insts))
        t = time.perf_counter()

        def step(name, **more):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            print(json.dumps(dict(
                type=ctype, arity=arity, step=name,
                seconds=round(now - t, 3),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                host_max_rss=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024, **more)),
                flush=True)
            t = time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        with ly.engine_override(cfg):
            sd = ly.base_setup_for_type(ctype, geo, device=dev)
            step("base_setup", shape=[sd.ir.log_n, sd.ir.num_witness])
            proofs = []
            for inst in insts[:arity]:
                proofs.append(ly.prove_base_instance(ctype, inst, ch, cap,
                                                     device=dev))
                assert ly.verify_base_instance(ctype, inst, ch, cap,
                                               proofs[-1], device=dev)
            step("base_prove_verify", proofs=len(proofs))
            # the leaf needs the base circuit's IR, config and VK only
            base_ir, base_cfg, base_vk = sd.ir, sd.config, sd.vk
            ly.drop_setup(sd)
            del sd
            torch.cuda.empty_cache()
            step("base_setup_dropped",
                 memory_allocated=torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()  # the leaf's peaks from here
            b, lay = lc.synthesize_leaf(base_ir, base_cfg, arity, ctype)
            step("synthesis", gates=b.num_gates,
                 permutations=len(b.perms))
            built = b.finalize()
            step("finalize", shape=[built.ir.log_n, built.ir.num_witness])
            setup = built.setup(cfg, device=dev)
            step("setup")
            W = b.fill_witness(lc.leaf_assignments(lay, base_vk, proofs),
                               device=dev)
            step("fill")
            proof = pk.prove(built.ir, setup, W, cfg, device=dev)
            step("prove", stage_peaks=dict(pk.STAGE_PEAKS))
            assert pk.verify(built.ir, setup.vk(), proof, cfg, device=dev)
            step("verify")
        del proofs, b, lay, built, setup, W, proof
        ly._SETUP_CACHE.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
