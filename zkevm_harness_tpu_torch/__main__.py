"""CLI: python -m zkevm_harness_tpu_torch <command> [--device DEVICE]

Counterpart of the JAX package's CLI (the reference exposes its tooling as
cargo binaries — geometry_config_generator,
circuit_synthesis_performance_test; this is the equivalent operator
surface):

  prove         --log-n N --width W --out proof.json   prove the flagship circuit
  verify        --log-n N --width W --proof proof.json verify a stored proof
  prove-block   --types 8 --out proof_tower            full chain for one block
  generate-vks  --types 1,5 --geometry production      base (+ recursion) VKs
  geometry      [--measured]                           print the geometry config
  bench-kernels                                        per-kernel times and bounds

Every command takes `--device`: the CUDA card by default (an error where
there is none), `cpu` to run the kernels' plain versions on the CPU. The
files written and the lines printed are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cfg(pk):
    return pk.PlonkishConfig(rate=2, cap_size=16, num_queries=40,
                             final_fri_size=64)


def _device(args):
    from .ops import goldilocks as gl
    return gl.resolve_device(args.device)


def cmd_prove(args):
    from .circuits import flagship as fl
    from .prover import plonkish as pk
    from .utils import serde

    dev = _device(args)
    cfg = _cfg(pk)
    ir = fl.flagship_ir(log_n=args.log_n, width=args.width)
    setup = fl.flagship_setup(ir, cfg, device=dev)
    witness = fl.flagship_witness(ir, seed=args.seed, device=dev)
    proof = pk.prove(ir, setup, witness, cfg, device=dev)
    assert pk.verify(ir, setup.vk(), proof, cfg, device=dev)
    with open(args.out, "w") as f:
        json.dump({"vk": setup.vk(), "proof": serde.proof_to_json(proof)}, f)
    print(f"proof written to {args.out} (verified)")


def cmd_verify(args):
    from .circuits import flagship as fl
    from .prover import plonkish as pk
    from .utils import serde

    dev = _device(args)
    cfg = _cfg(pk)
    ir = fl.flagship_ir(log_n=args.log_n, width=args.width)
    with open(args.proof) as f:
        blob = json.load(f)
    proof = serde.proof_from_json(blob["proof"], serde.default_registry())
    ok = pk.verify(ir, [int(v) for v in blob["vk"]], proof, cfg, device=dev)
    print("VALID" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def demo_block(isa):
    """The built-in block of `prove-block`: a storage write, an event, three
    heap round trips and a near call whose callee writes storage."""
    I = isa.imm
    return [
        isa.StorageWrite(I(1), I(100)),
        isa.Event(I(2), I(3)),
        isa.HeapWrite(I(0), I(55)),
        isa.HeapRead(I(0), 2),
        isa.HeapWrite(I(1), I(66)),
        isa.HeapRead(I(1), 3),
        isa.HeapWrite(I(2), I(77)),
        isa.HeapRead(I(2), 4),
        isa.NearCall(target=10, exception_handler=9),
        isa.Ret(),
        isa.StorageWrite(I(9), I(200)),
        isa.Ret(),
    ]


def cmd_prove_block(args):
    """Prove a block through the FULL chain (base -> leaf -> node ->
    scheduler -> compression -> SNARK wrapper), writing every real proof to
    a LocalFileDataSource in the reference's naming scheme — the operator
    surface of the product (reference README "How to use":
    external_calls::run + resume from the proof storage). The SNARK proof
    goes into the store's wrapper slot
    (test_proofs/aux_layer/wrapper_proof.json).

    The block comes from `--artifact block.json` (a TestArtifact: entry
    code + predeployed contracts, utils/test_artifacts.py), `--asm f.asm`
    (EraVM assembly through the vm/eravm front end), or the built-in demo
    block when neither is given."""
    from . import full_chain as fc
    from .prover import plonkish as pk
    from .utils.data_source import LocalFileDataSource
    from .vm import isa

    dev = _device(args)
    contracts = None
    if args.artifact:
        from .utils.test_artifacts import load_artifact
        art = load_artifact(args.artifact)
        block = list(art.entry_point_code)
        contracts = dict(art.predeployed_contracts)
        print(f"[prove-block] artifact {args.artifact}: entry "
              f"0x{art.entry_point_address:x}, "
              f"{len(contracts)} predeployed contracts")
    elif args.asm:
        from .vm import eravm
        with open(args.asm) as f:
            _words, block = eravm.assemble_era_program(f.read())
        print(f"[prove-block] assembled {args.asm}: "
              f"{len(block)} instructions")
    else:
        block = demo_block(isa)
    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=args.num_queries,
                            final_fri_size=8)
    source = LocalFileDataSource(args.out)
    chain_types = tuple(int(t) for t in args.types.split(","))
    result = fc.prove_block_full_chain(
        block, chain_types=chain_types, base_cfg=cfg, recursion_cfg=cfg,
        compression_cfg=cfg, wrap=not args.no_wrap,
        for_wrapper=args.for_wrapper,
        compression_layers=args.compression_layers,
        contracts=contracts, cycle_limit=args.cycle_limit,
        progress=lambda m: print(f"[prove-block] {m}", flush=True),
        source=source, device=dev)
    if result.snark is not None:
        from .convert import plonk_proof_to_json
        source.set_wrapper_proof(plonk_proof_to_json(result.snark["proof"]))
    print(f"block commitment: {[int(v) for v in result.scheduler_pi]}")
    print(f"proof tower written to {args.out}")


def cmd_generate_vks(args):
    """One-shot all-layer VK generation (the reference's
    generate_base_layer_vks / generate_recursive_layer_vks,
    src/compute_setups.rs:65-612): every base type's VK at the given
    geometry, plus per-type leaf and node VKs at the chosen recursion
    arity, written to a LocalFileDataSource."""
    import contextlib
    import hashlib
    import time
    from .circuits import leaf_circuit as lc
    from .circuits import node_circuit as nc
    from .circuits.types import GeometryConfig, testing_geometry
    from .prover import layers as ly
    from .prover import plonkish as pk
    from .utils.data_source import LocalFileDataSource

    dev = _device(args)
    if args.geometry == "production":
        # the committed reference-parity capacities (compute_setups.rs
        # runs at this geometry; TARGET_CIRCUIT_TRACE_LENGTH shapes); the
        # wide types (1, 5, 7, 10 at full capacity) are selected with
        # --types
        geometry = GeometryConfig()
        prod_cfg = pk.PlonkishConfig(rate=2, cap_size=16,
                                     num_queries=args.num_queries,
                                     final_fri_size=512)
    else:
        geometry = testing_geometry()
        prod_cfg = None
    rec_cfg = pk.PlonkishConfig(rate=2, cap_size=4,
                                num_queries=args.num_queries,
                                final_fri_size=8)
    source = LocalFileDataSource(args.out)
    types = ([int(t) for t in args.types.split(",")] if args.types
             else list(range(1, 14)))
    digests = {}
    override = (ly.engine_override(prod_cfg) if prod_cfg is not None
                else contextlib.nullcontext())
    with override:
        for t in types:
            t0 = time.time()
            sd = ly.base_setup_for_type(t, geometry, device=dev)
            source.set_base_layer_vk(list(sd.vk), t)
            dg = hashlib.sha256(
                ",".join(str(int(v)) for v in sd.vk).encode()).hexdigest()
            digests[t] = dg
            print(f"[vks] base[{t}] vk written "
                  f"(2^{sd.ir.log_n} x {sd.ir.num_witness}, "
                  f"{time.time() - t0:.1f}s, sha256 {dg[:16]})", flush=True)
            if args.recursion:
                t0 = time.time()
                b, _lay = lc.synthesize_leaf(sd.ir, sd.config,
                                             arity=args.arity,
                                             base_circuit_type=t)
                built = b.finalize()
                lsetup = built.setup(rec_cfg, device=dev)
                source.set_recursion_layer_vk(lsetup.vk(), t + 2)
                nb, _nl = nc.synthesize_node(built.ir, rec_cfg,
                                             arity=args.arity)
                nbuilt = nb.finalize()
                nsetup = nbuilt.setup(rec_cfg, device=dev)
                source.set_recursion_layer_vk(nsetup.vk(), 2)
                print(f"[vks] leaf[{t}] + node vks written "
                      f"(leaf 2^{built.ir.log_n} x {built.ir.num_witness}, "
                      f"{time.time() - t0:.1f}s)", flush=True)
    # merge with digests from earlier runs (the production set is
    # generated in batches — heavy types need runs of their own)
    prior = source.get("vk_digests") or {}
    merged = dict(prior.get("vk_sha256", {}))
    merged.update({str(k): v for k, v in digests.items()})
    source.set({"geometry": args.geometry, "vk_sha256": merged},
               "vk_digests")
    print(f"verification keys written to {args.out}")


def cmd_geometry(args):
    """--measured searches the REAL gate library (this framework's own
    capacities, capacity.measured_geometry); default reproduces the
    committed reference-parity values (calibrated models). Host code; the
    device is resolved all the same, as in every command."""
    _device(args)
    if args.measured:
        from .circuits.capacity import measured_geometry
        cfg = measured_geometry(verbose=True)
    else:
        from .circuits.capacity import (calibrated_cost_models,
                                        generate_geometry_config)
        cfg = generate_geometry_config(calibrated_cost_models())
    print(json.dumps(cfg.__dict__, indent=1))


def cmd_bench_kernels(args):
    from .utils.kernel_bench import bench_kernels
    bench_kernels(device=_device(args))


def main(argv=None):
    p = argparse.ArgumentParser(prog="zkevm_harness_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        sp = sub.add_parser(name)
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; cpu "
                             "runs the kernels' plain versions)")
        sp.set_defaults(fn=fn)
        return sp

    pp = add("prove", cmd_prove)
    pp.add_argument("--log-n", type=int, default=8)
    pp.add_argument("--width", type=int, default=16)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--out", default="proof.json")

    pv = add("verify", cmd_verify)
    pv.add_argument("--log-n", type=int, default=8)
    pv.add_argument("--width", type=int, default=16)
    pv.add_argument("--proof", default="proof.json")

    pfb = add("prove-block", cmd_prove_block)
    pfb.add_argument("--types", default="8",
                     help="comma-separated base circuit types to chain")
    pfb.add_argument("--num-queries", type=int, default=2,
                     help="FRI queries (2 = structural test scale)")
    pfb.add_argument("--compression-layers", type=int, default=1)
    pfb.add_argument("--for-wrapper", action="store_true",
                     help="hash the final compression with Bn256 Poseidon2")
    pfb.add_argument("--no-wrap", action="store_true",
                     help="stop after the scheduler proof")
    pfb.add_argument("--artifact", default=None,
                     help="TestArtifact JSON (entry code + predeploys)")
    pfb.add_argument("--asm", default=None,
                     help="EraVM .asm text file (vm/eravm dialect)")
    pfb.add_argument("--cycle-limit", type=int, default=10_000)
    pfb.add_argument("--out", default="proof_tower",
                     help="LocalFileDataSource directory for the tower")

    pvk = add("generate-vks", cmd_generate_vks)
    pvk.add_argument("--types", default="",
                     help="comma-separated base types (default: all 13)")
    pvk.add_argument("--recursion", action="store_true",
                     help="also generate per-type leaf + node VKs")
    pvk.add_argument("--arity", type=int, default=2)
    pvk.add_argument("--num-queries", type=int, default=2)
    pvk.add_argument("--geometry", default="testing",
                     choices=("testing", "production"),
                     help="production = committed reference capacities at "
                          "the production proof config (select the wide "
                          "types with --types)")
    pvk.add_argument("--out", default="vk_store")

    pg = add("geometry", cmd_geometry)
    pg.add_argument("--measured", action="store_true",
                    help="binary-search the real synthesized circuit "
                         "geometries instead of the calibrated models")

    add("bench-kernels", cmd_bench_kernels)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
