"""K3's launch bound on the card: `csrc/poseidon2_bn254.cu` as it is
(`__launch_bounds__(128)`, the registers left to ptxas) against the same
source bound to 8 and to 6 blocks of 128 an SM (64 and 80 registers a
thread), each built side by side, checked bit for bit against the package's
kernel and timed at the production for-wrapper tree's shapes:

    python tools/k3_launch_bounds.py [--reps 10] [--rounds 2]

Prints, per variant, ptxas' registers, stack and spill bytes of both kernels
and ms per launch (CUDA events) of `bn254_hash_rows` at (72, 2^18) and
`bn254_hash_pairs` at 2^17 pairs, the variants interleaved round by round
(this, blocks8, blocks6, then the reverse), and writes the same JSON to
chiprun_out/k3_launch_bounds.json. Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zkevm_harness_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

_BOUND = "__launch_bounds__(kThreads)"


def variant_source(text: str, name: str) -> str:
    """The text of `csrc/poseidon2_bn254.cu` for variant `name` ("this",
    "blocks8", "blocks6"). Raises if the launch bound is no longer in the
    source as this script expects it."""
    if text.count(_BOUND) != 2:
        raise ValueError(f"want {_BOUND!r} on both kernels of the source")
    blocks = {"this": None, "blocks8": 8, "blocks6": 6}[name]
    if blocks is None:
        return text
    return text.replace(_BOUND, f"__launch_bounds__(kThreads, {blocks})")


VARIANTS = ("this", "blocks8", "blocks6")


def build(out_dir: str):
    """One nvcc per variant, all started together; returns {name: (lib,
    ptxas report)}."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ck.CSRC_DIR, "poseidon2_bn254.cu")) as f:
        text = f.read()
    procs = {}
    for name in VARIANTS:
        src = os.path.join(out_dir, f"k3_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, name))
        so = os.path.join(out_dir, f"libk3_{name}.so")
        cmd = [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-I", ck.CSRC_DIR,
               "-o", so, src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(so)
        lib.bn254_set_constants.argtypes = [ctypes.c_void_p] * 4
        lib.bn254_hash_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.bn254_hash_pairs_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
        report = {k.split("_kernel")[0].rsplit("hash_", 1)[-1]: v
                  for k, v in ck.ptxas_report(out).items()}
        built[name] = (lib, report)
    return built


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_launch_bounds: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    built = build(os.path.join(ck.BUILD_DIR, "k3_launch_bounds"))
    tables = ck.bn254_constant_tables()
    for lib, _ in built.values():
        ck._check(lib.bn254_set_constants(*(t.ctypes.data for t in tables)),
                  "bn254_set_constants")

    g = torch.Generator(device=dev).manual_seed(10)
    width, rows, m = 72, 1 << 18, 1 << 17
    cols = torch.randint(0, 1 << 62, (width, rows), generator=g, device=dev)
    # canonical Fr: the top limb below p's
    limbs = torch.randint(0, 1 << 62, (2 * m, 4), generator=g, device=dev)
    limbs[:, 3] %= 0x30644E72E131A029
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rows_fn(lib):
        out = torch.empty((rows, 4), dtype=torch.int64, device=dev)
        ck._check(lib.bn254_hash_rows_launch(cols.data_ptr(), width, rows,
                                             out.data_ptr(), stream), "rows")
        return out

    def pairs_fn(lib):
        out = torch.empty((m, 4), dtype=torch.int64, device=dev)
        ck._check(lib.bn254_hash_pairs_launch(limbs.data_ptr(), m,
                                              out.data_ptr(), stream),
                  "pairs")
        return out

    want_rows, want_pairs = ck.bn254_hash_rows(cols), ck.bn254_hash_pairs(limbs)
    differing = {name: int((rows_fn(lib) != want_rows).sum())
                 + int((pairs_fn(lib) != want_pairs).sum())
                 for name, (lib, _) in built.items()}

    def ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return round(e0.elapsed_time(e1) / args.reps, 4)

    times = {name: {"rows_ms": [], "pairs_ms": []} for name in VARIANTS}
    for r in range(args.rounds):
        order = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
        for name in order:
            lib = built[name][0]
            times[name]["rows_ms"].append(ms(lambda: rows_fn(lib)))
            times[name]["pairs_ms"].append(ms(lambda: pairs_fn(lib)))
    result = {"card": card.strip(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "reps": args.reps,
              "shapes": {"rows": [width, rows], "pairs": m},
              "variants": {name: {"ptxas": built[name][1],
                                  "elements_differing": differing[name],
                                  **times[name]} for name in VARIANTS}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k3_launch_bounds.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if any(differing.values()):
        sys.exit("k3_launch_bounds: a variant differs from the kernel")


if __name__ == "__main__":
    main()
