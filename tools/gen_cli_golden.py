"""Write the golden artifacts of the operator CLI, the AIR STARK engine, the
gadget circuits and the production VKs of types 1 and 5, with the JAX
package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_cli_golden.py [stage ...]

Stages (all by default, in this order):
  stark       test_artifacts/stark_fib_log6_proof.json: `stark.prove` of the
              fib-mul AIR (`golden.fib_mul_transitions`) at log_n 6 under
              `golden.STARK_GOLDEN_CONFIG`, verified;
  gadgets     test_artifacts/gadget_{ext_chain,inverse,fri_fold,transcript,
              merkle}_{vk,proof}.json: each gadget circuit at the shape of
              its JAX test, with the fixed inputs of `golden.py`, verified;
  cli_prove   test_artifacts/cli_prove_log8_w16.json: the CLI's
              `prove --log-n 8 --width 16 --seed 0`;
  geometry    test_artifacts/cli_geometry{,_measured}.txt: what the CLI's
              `geometry` and `geometry --measured` print;
  vks_testing test_artifacts/cli_vks8_{base,leaf,node}_vk.json: the CLI's
              `generate-vks --types 8 --recursion` at testing geometry;
  cli_block   test_artifacts/cli_block_{scheduler,compression,snark}_
              proof.json and cli_block_summary.json (the block commitment):
              the CLI's `prove-block --types 8` over its demo block. The JAX
              CLI's own file store cannot write a proof record, so this
              stage runs that command's body over `_FileSource`, which
              writes records as the port's store does;
  vk1, vk5    test_artifacts/vk_{1,5}_production.json: the production VKs
              that `generate-vks --geometry production` writes, through
              `layers.base_setup_for_type(t, GeometryConfig())` at the
              base-layer config (rate 2, cap 16).

Each stage prints its seconds. The PyTorch port is held against these files
byte for byte. Rerun only after an intentional protocol change.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from zkevm_harness_tpu import __main__ as cli  # noqa: E402
from zkevm_harness_tpu import full_chain  # noqa: E402
from zkevm_harness_tpu.circuits import ext_gadget as eg  # noqa: E402
from zkevm_harness_tpu.circuits import fri_fold_circuit as fc  # noqa: E402
from zkevm_harness_tpu.circuits import merkle_circuit as mc  # noqa: E402
from zkevm_harness_tpu.circuits import transcript_gadget as tg  # noqa: E402
from zkevm_harness_tpu.circuits.types import GeometryConfig  # noqa: E402
from zkevm_harness_tpu.ops import goldilocks as gl  # noqa: E402
from zkevm_harness_tpu.ops import merkle as mk  # noqa: E402
from zkevm_harness_tpu.prover import layers as ly  # noqa: E402
from zkevm_harness_tpu.prover import plonkish as pk  # noqa: E402
from zkevm_harness_tpu.prover import stark as st  # noqa: E402
from zkevm_harness_tpu.utils import serde  # noqa: E402
from zkevm_harness_tpu.utils.data_source import \
    LocalFileDataSource  # noqa: E402
from zkevm_harness_tpu.vm import isa  # noqa: E402
from zkevm_harness_tpu_torch import golden  # noqa: E402
from zkevm_harness_tpu_torch.__main__ import demo_block  # noqa: E402
from zkevm_harness_tpu_torch.convert import plonk_proof_to_json  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")


def _write_json(name, obj):
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(obj, f)


def _write(name, vk, proof):
    _write_json(f"{name}_vk.json", [int(v) for v in vk])
    _write_json(f"{name}_proof.json", serde.proof_to_json(proof))


def fib_mul_air(log_n):
    return st.Air(width=3, log_n=log_n, constraint_degree=2,
                  num_transitions=3,
                  eval_transitions=golden.fib_mul_transitions,
                  boundary=golden.FIB_MUL_BOUNDARY)


def stage_stark():
    log_n = golden.STARK_GOLDEN_LOG_N
    cfg = st.StarkConfig(**golden.STARK_GOLDEN_CONFIG)
    air = fib_mul_air(log_n)
    trace = gl.from_int(np.array(golden.fib_mul_trace(log_n), dtype=object))
    proof = st.prove(air, trace, cfg)
    assert st.verify(air, proof, cfg, strict=True)
    _write_json(f"stark_fib_log{log_n}_proof.json", serde.proof_to_json(proof))


def _prove_gadget(name, ir, setup, witness, cfg):
    proof = pk.prove(ir, setup, witness, cfg)
    assert pk.verify(ir, setup.vk(), proof, cfg, strict=True)
    _write(f"gadget_{name}", setup.vk(), proof)


def stage_gadgets():
    cfg8 = pk.PlonkishConfig(**golden.GADGET_CONFIG)
    cfg16 = pk.PlonkishConfig(**golden.GADGET_CONFIG_16)

    ir = eg.ext_chain_ir(golden.EXT_CHAIN_LOG_N)
    _prove_gadget("ext_chain", ir, eg.ext_chain_setup(ir, cfg8),
                  eg.ext_chain_witness(ir, golden.EXT_CHAIN_BASE), cfg8)

    ir = eg.inverse_ir(golden.INVERSE_LOG_N)
    _prove_gadget("inverse", ir,
                  eg.inverse_setup(ir, cfg8, len(golden.INVERSE_XS)),
                  eg.inverse_witness(ir, golden.INVERSE_XS), cfg8)

    ir = fc.fold_ir(golden.FRI_FOLD_LOG_N)
    rows = golden.FRI_FOLD_ROWS
    witness, _folded = fc.fold_witness(ir, rows)
    _prove_gadget("fri_fold", ir, fc.fold_setup(ir, [r[3] for r in rows],
                                                cfg8), witness, cfg8)

    ir = tg.transcript_ir(golden.TRANSCRIPT_LOG_N, golden.TRANSCRIPT_BLOCKS)
    _prove_gadget("transcript", ir, tg.transcript_setup(ir, cfg16),
                  tg.transcript_witness(ir, golden.TRANSCRIPT_CHUNKS), cfg16)

    leaves = gl.from_int(np.array(golden.MERKLE_LEAVES, dtype=object))
    tree = mk.build_tree(leaves, 1)
    idx = golden.MERKLE_INDEX
    path = gl.to_u64(mk.open_indices(tree, np.array([idx], np.uint32)))[0]
    depth = path.shape[0]
    ir = mc.merkle_ir(golden.MERKLE_LOG_N)
    witness, root = mc.merkle_witness(
        ir, list(golden.MERKLE_LEAVES[idx]),
        [[int(v) for v in lvl] for lvl in path],
        [(idx >> d) & 1 for d in range(depth)])
    assert root == [int(v) for v in gl.to_u64(tree.cap)[0]]
    _prove_gadget("merkle", ir, mc.merkle_setup(ir, cfg16), witness, cfg16)


def stage_cli_prove():
    cli.main(["prove", "--log-n", "8", "--width", "16", "--seed", "0",
              "--out", os.path.join(OUT, "cli_prove_log8_w16.json")])


def _printed(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def stage_geometry():
    for name, argv in (("cli_geometry.txt", ["geometry"]),
                       ("cli_geometry_measured.txt",
                        ["geometry", "--measured"])):
        with open(os.path.join(OUT, name), "w") as f:
            f.write(_printed(argv))


def stage_vks_testing():
    with tempfile.TemporaryDirectory() as tmp:
        cli.main(["generate-vks", "--types", "8", "--recursion",
                  "--out", tmp])
        for what, rel in (("base", "setup/base_layer/vk_8.json"),
                          ("leaf", "setup/recursion_layer/vk_10.json"),
                          ("node", "setup/recursion_layer/vk_2.json")):
            shutil.copyfile(os.path.join(tmp, rel),
                            os.path.join(OUT, f"cli_vks8_{what}_vk.json"))


class _FileSource(LocalFileDataSource):
    """The JAX package's file store with its records' proofs in serde form
    (its own hands them to `json.dump` as they are, which refuses them): the
    store of the port's CLI."""

    def get(self, *key):
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return serde.proof_from_json(json.load(f),
                                         serde.default_registry())

    def set(self, value, *key):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(value, f, default=serde.proof_to_json)


def stage_cli_block():
    """The body of the JAX CLI's `prove-block --types 8` (demo block, its
    defaults) over `_FileSource`, the SNARK proof then written into the
    store's wrapper slot, as the port's CLI does."""
    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=2,
                            final_fri_size=8)
    with tempfile.TemporaryDirectory() as tmp:
        source = _FileSource(tmp)
        result = full_chain.prove_block_full_chain(
            demo_block(isa), chain_types=(8,), base_cfg=cfg,
            recursion_cfg=cfg, compression_cfg=cfg, wrap=True,
            for_wrapper=False, compression_layers=1, contracts=None,
            cycle_limit=10_000,
            progress=lambda m: print(f"[prove-block] {m}", flush=True),
            source=source)
        source.set_wrapper_proof(plonk_proof_to_json(result.snark["proof"]))
        text = f"block commitment: {[int(v) for v in result.scheduler_pi]}"
        print(text, flush=True)
        for what, rel in (
                ("scheduler", "test_proofs/recursion_layer/scheduler_proof.json"),
                ("compression", "test_proofs/aux_layer/compression_proof_1.json"),
                ("snark", "test_proofs/aux_layer/wrapper_proof.json")):
            shutil.copyfile(os.path.join(tmp, rel),
                            os.path.join(OUT, f"cli_block_{what}_proof.json"))
    line = next(s for s in text.splitlines()
                if s.startswith("block commitment: "))
    _write_json("cli_block_summary.json",
                {"block_commitment": json.loads(line.split(": ", 1)[1])})


def _stage_vk(t):
    sd = ly.base_setup_for_type(t, GeometryConfig())
    print(f"  type {t}: {sd.ir.num_witness} x 2^{sd.ir.log_n}", flush=True)
    _write_json(f"vk_{t}_production.json", [int(v) for v in sd.vk])


STAGES = {"stark": stage_stark, "gadgets": stage_gadgets,
          "cli_prove": stage_cli_prove, "geometry": stage_geometry,
          "vks_testing": stage_vks_testing, "cli_block": stage_cli_block,
          "vk1": lambda: _stage_vk(1), "vk5": lambda: _stage_vk(5)}


def main():
    for name in sys.argv[1:] or list(STAGES):
        t0 = time.time()
        STAGES[name]()
        print(f"{name} written ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
