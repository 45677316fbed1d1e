#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # full run: 130 columns x 2^19 rows
    python3 chip_smoke.py --log-n 16 # same width, fewer rows

It needs one CUDA card and exits non-zero without one. It imports nothing of
JAX and nothing of the JAX package. Phases, one JSON object per line:

  1. device    card name and power limit (nvidia-smi), torch/CUDA versions
  2. build     nvcc build of every kernel under zkevm_harness_tpu_torch/csrc
  3. kernels   each kernel against its plain PyTorch version on the card,
               bit for bit (integers: tolerance 0), and timed with CUDA
               events at the main path's shapes
  4. golden    the golden circuit (log_n 6, width 8, seed 42) proved on the
               card equals test_artifacts/flagship_log6_{vk,proof}.json
  5. main      flagship circuit at full width: setup, witness, prove, verify,
               three tampered proofs rejected; launch counters read
  6. kernels   one line {"kernels": [...], "helpers": [...]}

The last line is {"ok": true, "device": {...}}. Any failed phase raises and
the run exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

WIDTH = 130  # the MainVM-shaped trace width; never cut
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_artifacts")

# Published peaks of one H100 SXM used for the bounds: 3.35 TB/s of device
# memory, and 67 TFLOP/s of float32, which is 132 SMs x 128 lanes x 2 (a
# multiply-add counts twice) x the boost clock. An SM has 64 INT32 lanes, half
# as many, and they do one add, compare or select a clock each: a quarter of
# that figure in integer instructions a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_ALU_PER_S = 67e12 / 4
# Integer-ALU instructions per field operation, counted in the SASS that
# `--sass` writes (built for sm_90a): a multiply is 7 IADD3, 6 ISETP, 6 SEL
# and 1 VIADD, beside 9 IMADs that run on the float32 lanes and so are not
# the tighter count; an add is 2 IADD3, 4 ISETP and 2 SEL beside 2 IMADs.
OPS_MUL = 20
OPS_ADD = 8
# per Poseidon2 state: 8*12*4 + 22*(4+12) multiplies; adds of 9 external
# layers (62 each), 96 + 22 round constants, 22 internal sums (23 each)
P2_MULS = 8 * 12 * 4 + 22 * (4 + 12)
P2_ADDS = 9 * 62 + 96 + 22 + 22 * 23


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def sass_counts(ck, out_dir):
    """Static instruction counts of every kernel in the built libraries, by
    opcode, from `cuobjdump -sass` (written in full under out_dir)."""
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    counts = {}
    for name in ck.SOURCES:
        text = subprocess.run([exe, "-sass", ck._lib_path(name)], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(text)
        func = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("Function :"):
                func = line.split(":", 1)[1].strip()
                counts[func] = {}
                continue
            # an instruction line reads "/*0040*/  IMAD.WIDE.U32 R2, ... ;"
            parts = line.split("*/", 1)
            if func is None or len(parts) < 2 or not line.startswith("/*"):
                continue
            words = parts[1].strip().split()
            if not words or words[0].startswith("/*"):
                continue
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.rstrip(";").split(".")[0]
            counts[func][op] = counts[func].get(op, 0) + 1
    return {f: dict(sorted(c.items(), key=lambda kv: -kv[1]), total=sum(
        c.values())) for f, c in counts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=19,
                    help="rows of the main-path trace as a power of two "
                         "(>= 16); the width stays 130")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's per-kernel register and spill report")
    ap.add_argument("--profile", action="store_true",
                    help="prove once more under torch.profiler and print the "
                         "device's busy share and the top kernels")
    ap.add_argument("--compare-broadcast", action="store_true",
                    help="prove again with the elementwise kernels' broadcast "
                         "operands materialised in PyTorch (all of them, and "
                         "all but scalars) and print the times beside the "
                         "in-kernel addressing's")
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="write cuobjdump's SASS of the built libraries into "
                         "DIR and print each kernel's instruction counts")
    ap.add_argument("--out", default=None,
                    help="also write all phase records to this JSON file")
    args = ap.parse_args(argv)
    if args.log_n < 16:
        ap.error("--log-n must be at least 16")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde, tracing

    t_start = time.time()
    records = []

    def phase(name, **fields):
        rec = {"phase": name, **fields}
        records.append(rec)
        emit(rec)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    P = gl.P

    # -- 1. device ----------------------------------------------------------
    smi = nvidia_smi_line()
    phase("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build -----------------------------------------------------------
    build_s = ck.build_all(force=True, verbose=args.verbose_build)
    phase("build", seconds=round(build_s, 3), sources=[
        f"zkevm_harness_tpu_torch/csrc/{n}.cu" for n in ck.SOURCES])

    if args.sass:
        phase("sass", kernels=sass_counts(ck, args.sass))

    # -- 3. kernels against their plain versions ----------------------------
    def check_equal(name, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version ({bad} elements differ)")
        return 0  # max abs error of an exact integer comparison

    def cuda_ms(fn, warm, reps):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    rng = np.random.default_rng(2024)

    def rand_field(shape):
        u = rng.integers(0, P, size=shape, dtype=np.uint64)
        return gl.from_u64(u, dev)

    edges = [e % P for e in
             [0, 1, P - 1, P - 2, 0xFFFFFFFF, 1 << 32, (1 << 63), 7]]
    ea = gl.from_int([a for a in edges for _ in edges], dev)
    eb = gl.from_int([b for _ in edges for b in edges], dev)
    binary = {"gl_mul": (ck.gl_mul, ck.gl_mul_plain),
              "gl_add": (ck.gl_add, ck.gl_add_plain),
              "gl_sub": (ck.gl_sub, ck.gl_sub_plain)}
    ra, rb = rand_field(1 << 20), rand_field(1 << 20)
    rag_a, rag_b = rand_field(1000003), rand_field(1000003)
    col = rand_field((7, 1))
    row = rand_field((1, 1000))
    errs = {}
    for name, (kern, plain) in binary.items():
        errs[name] = max(
            check_equal(name + " edges", kern(ea, eb), plain(ea, eb)),
            check_equal(name + " 2^20", kern(ra, rb), plain(ra, rb)),
            check_equal(name + " ragged", kern(rag_a, rag_b),
                        plain(rag_a, rag_b)),
            # the broadcasts the prover uses: scalar, row, column
            check_equal(name + " scalar", kern(ra, rb[5]), plain(ra, rb[5])),
            check_equal(name + " row", kern(ra.reshape(1024, 1024), rb[:1024]),
                        plain(ra.reshape(1024, 1024), rb[:1024])),
            check_equal(name + " col", kern(col, row), plain(col, row)))
    edge_vec = gl.from_int(edges, dev)
    errs["gl_pow7"] = max(
        check_equal("gl_pow7 edges", ck.gl_pow7(edge_vec),
                    ck.gl_pow7_plain(edge_vec)),
        check_equal("gl_pow7 ragged", ck.gl_pow7(rag_a),
                    ck.gl_pow7_plain(rag_a)))
    del rag_a, rag_b

    vals = np.random.default_rng(0).integers(0, P, size=(16, 12),
                                             dtype=np.uint64)
    vals[0] = P - 1
    vals[1, :6] = 0
    vals[1, 6:] = P - 2
    vals[2] = 0
    st16 = gl.from_u64(vals, dev)
    st_rand = rand_field((1 << 16, 12))
    errs["poseidon2_permute"] = max(
        check_equal("poseidon2 16 states", ck.poseidon2_permute(st16),
                    ck.poseidon2_permute_plain(st16)),
        check_equal("poseidon2 single state", ck.poseidon2_permute(st16[3:4]),
                    ck.poseidon2_permute_plain(st16[3:4])),
        check_equal("poseidon2 2^16 states", ck.poseidon2_permute(st_rand),
                    ck.poseidon2_permute_plain(st_rand)))
    pinned = gl.to_ints(ck.poseidon2_permute(
        gl.from_int(list(range(12)), dev)[None]))[0]
    if [int(v) for v in pinned[:2]] != [16554216206709474952,
                                        11165653368081738105]:
        raise SystemExit("poseidon2_permute: pinned vector mismatch")
    del st_rand

    # timings at the main path's shapes
    n_rows = 1 << args.log_n
    n_el = n_rows * WIDTH
    ta, tb = rand_field((WIDTH, n_rows)), rand_field((WIDTH, n_rows))
    timing = {}
    # each kernel is first held against its plain version at the very shape
    # it is timed at, so max_abs_err covers the main path's shapes too
    for name, (kern, plain) in binary.items():
        errs[name] = max(errs[name], check_equal(
            name + " main shape", kern(ta, tb), plain(ta, tb)))
        timing[name] = {
            "ms": cuda_ms(lambda: kern(ta, tb), 2, 10),
            "plain_ms": cuda_ms(lambda: plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * n_el,
            "ops": n_el * (OPS_MUL if name == "gl_mul" else OPS_ADD)}
    errs["gl_pow7"] = max(errs["gl_pow7"], check_equal(
        "gl_pow7 main shape", ck.gl_pow7(ta), ck.gl_pow7_plain(ta)))
    timing["gl_pow7"] = {
        "ms": cuda_ms(lambda: ck.gl_pow7(ta), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.gl_pow7_plain(ta), 1, 3),
        "bytes": 2 * 8 * n_el, "ops": n_el * 4 * OPS_MUL}
    del ta, tb
    n_states = 2 * n_rows  # leaves of a rate-2 commitment
    ts = rand_field((n_states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 main shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing["poseidon2_permute"] = {
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * n_states,
        "ops": n_states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    torch.cuda.empty_cache()
    for t in timing.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_vs_plain", tolerance=0, max_abs_err=errs,
          shapes={"elementwise": [WIDTH, n_rows],
                  "poseidon2_permute": [n_states, 12]},
          timing={k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                      for kk, vv in t.items()} for k, t in timing.items()})

    # -- 4. golden path on the card ------------------------------------------
    gcfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=8,
                             final_fri_size=8)
    gir = fl.flagship_ir(log_n=6, width=8)
    t0 = time.time()
    gsetup = fl.flagship_setup(gir, gcfg, device=dev)
    with open(os.path.join(GOLDEN_DIR, "flagship_log6_vk.json")) as f:
        golden_vk = [int(v) for v in json.load(f)]
    if gsetup.vk() != golden_vk:
        raise SystemExit("golden: verification key differs")
    gproof = pk.prove(gir, gsetup, fl.flagship_witness(gir, seed=42,
                                                       device=dev),
                      gcfg, device=dev)
    with open(os.path.join(GOLDEN_DIR, "flagship_log6_proof.json")) as f:
        golden_proof = json.load(f)
    if json.loads(json.dumps(serde.proof_to_json(gproof))) != golden_proof:
        raise SystemExit("golden: proof differs from the golden JSON")
    if not pk.verify(gir, golden_vk, gproof, gcfg, device=dev, strict=True):
        raise SystemExit("golden: proof does not verify")
    torch.cuda.synchronize()
    phase("golden", vk_equal=True, proof_equal=True, verify=True,
          seconds=round(time.time() - t0, 3))

    # -- 5. main path at full width ------------------------------------------
    cfg = pk.PlonkishConfig(rate=2, cap_size=16, num_queries=40,
                            final_fri_size=512)
    ir = fl.flagship_ir(log_n=args.log_n, width=WIDTH)
    tracing.GLOBAL.enabled = True
    tracing.GLOBAL.sync = torch.cuda.synchronize
    tracing.GLOBAL.spans.clear()
    tracing.GLOBAL.counters.clear()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    setup, setup_s = timed(lambda: fl.flagship_setup(ir, cfg, device=dev))
    witness, witness_s = timed(
        lambda: fl.flagship_witness(ir, seed=0, device=dev))
    proof, prove_s = timed(lambda: pk.prove(ir, setup, witness, cfg,
                                            device=dev))
    vk = setup.vk()
    ok, verify_s = timed(lambda: pk.verify(ir, vk, proof, cfg, device=dev,
                                           strict=True))
    launches = dict(ck.LAUNCHES)
    # once more with the shape's tables (twiddles, domains, bit reversal)
    # cached: the time a prover pays from its second proof on. The proof is a
    # function of circuit, witness and config only, so it must come out equal.
    stages_first = tracing.GLOBAL.flat_durations()
    tracing.GLOBAL.spans.clear()
    proof_again, prove_warm_s = timed(lambda: pk.prove(ir, setup, witness,
                                                       cfg, device=dev))
    del witness
    if serde.proof_to_json(proof_again) != serde.proof_to_json(proof):
        raise SystemExit("main path: a second prove gave a different proof")
    del proof_again
    if not ok:
        raise SystemExit("main path: proof does not verify")
    for name in launches:
        if launches[name] <= 0:
            raise SystemExit(f"main path launched {name} no time")

    # shape checks by the repo's own means: widths and finite canonical values
    assert len(proof.ood_witness) == WIDTH
    assert all(0 <= v < P for pair in proof.ood_witness for v in pair)
    assert proof.witness_cap.shape == (cfg.cap_size, 4)

    def tampered(mutate):
        bad = copy.deepcopy(proof)
        mutate(bad)
        return pk.verify(ir, vk, bad, cfg, device=dev)  # tolerant: no raise

    def bump_pi(p):
        p.public_inputs[0] = (p.public_inputs[0] + 1) % P

    def bump_ood(p):
        c0, c1 = p.ood_witness[3]
        p.ood_witness[3] = ((c0 + 1) % P, c1)

    def bump_opening(p):
        idx = sorted(p.openings["witness"].keys())[0]
        p.openings["witness"][idx][0] = (p.openings["witness"][idx][0] + 1) % P

    rejected = {"public_input": not tampered(bump_pi),
                "ood_witness": not tampered(bump_ood),
                "opening": not tampered(bump_opening)}
    if not all(rejected.values()):
        raise SystemExit(f"main path: a tampered proof was accepted: {rejected}")
    def prove_stages(durations):
        return {k: round(v, 4) for k, v in durations.items()
                if k.startswith("plonkish.prove")}

    stages = prove_stages(stages_first)
    stages_warm = prove_stages(tracing.GLOBAL.flat_durations())
    tracing.GLOBAL.enabled = False
    cells = n_rows * WIDTH
    phase("main_path", log_n=args.log_n, width=WIDTH,
          config={"rate": cfg.rate, "cap_size": cfg.cap_size,
                  "num_queries": cfg.num_queries,
                  "final_fri_size": cfg.final_fri_size},
          witness_seed=0, setup_s=round(setup_s, 3),
          witness_s=round(witness_s, 3), prove_s=round(prove_s, 3),
          prove_warm_s=round(prove_warm_s, 3),
          verify_s=round(verify_s, 3), verify=True,
          cells_per_s=round(cells / prove_s, 1),
          cells_per_s_warm=round(cells / prove_warm_s, 1),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          tampered_rejected=rejected, launches=launches, stages_s=stages,
          stages_warm_s=stages_warm)

    def device_rows(fn):
        """Run fn under torch.profiler; (wall seconds, device-side rows)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_s = time.time() - t0
        # device-side rows only (kernels and copies): the operator rows carry
        # the same device time a second time
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        if not rows:
            raise SystemExit("profile: the trace shows no device time")
        return wall_s, rows

    # -- optional: device busy share of one more prove -----------------------
    if args.profile:
        witness = fl.flagship_witness(ir, seed=0, device=dev)
        wall_s, rows = device_rows(
            lambda: pk.prove(ir, setup, witness, cfg, device=dev))
        del witness
        busy_s = sum(r[2] for r in rows) / 1e6
        top = sorted(rows, key=lambda r: -r[2])[:12]
        # kernel times do not depend on the profiler, the wall time does: the
        # idle share is taken against the unprofiled warm prove above
        phase("profile", profiled_wall_s=round(wall_s, 3),
              prove_warm_s=round(prove_warm_s, 3),
              device_busy_s=round(busy_s, 3),
              device_idle_share=round(1 - busy_s / prove_warm_s, 3),
              top_kernels=[{"name": k[:80], "count": c,
                            "device_ms": round(us / 1e3, 2)}
                           for k, c, us in top])

    # -- optional: broadcasts addressed in the kernel against materialised ----
    if args.compare_broadcast:
        witness = fl.flagship_witness(ir, seed=0, device=dev)
        want = serde.proof_to_json(proof)
        in_kernel = ck._operand

        def materialise_all(t, shape, n):
            return t.expand(shape).contiguous(), 1, n

        def materialise_but_scalars(t, shape, n):
            if t.numel() == 1:
                return t.reshape(1), 1, 1
            return t.expand(shape).contiguous(), 1, n

        variants = [("in_kernel", in_kernel),
                    ("materialise_all", materialise_all),
                    ("materialise_but_scalars", materialise_but_scalars)]
        runs = []
        # there and back, so that a drift of the card shows as a difference
        # between the two readings of one variant
        for label, fn in variants + variants[::-1]:
            ck._operand = fn
            torch.cuda.reset_peak_memory_stats()
            got, secs = timed(lambda: pk.prove(ir, setup, witness, cfg,
                                               device=dev))
            if serde.proof_to_json(got) != want:
                raise SystemExit(f"compare-broadcast: {label} gave a "
                                 "different proof")
            del got
            runs.append({"operands": label, "prove_warm_s": round(secs, 4),
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated()})
        # the device's own time does not depend on how fast the host
        # launches: one profiled prove for each
        for label, fn in variants:
            ck._operand = fn
            _, rows = device_rows(
                lambda: pk.prove(ir, setup, witness, cfg, device=dev))
            busy = {"operands": label,
                    "device_busy_s": round(sum(r[2] for r in rows) / 1e6, 4)}
            for key in ("binary_kernel", "elementwise_kernel"):
                busy[key + "_s"] = round(sum(
                    r[2] for r in rows if key in r[0]) / 1e6, 4)
                busy[key + "_launches"] = sum(
                    r[1] for r in rows if key in r[0])
            runs.append(busy)
        del witness
        # one multiply by a row, a column and a scalar, both ways
        full = rand_field((WIDTH, n_rows))
        single = {}
        for what, small in (("row", rand_field((1, n_rows))),
                            ("column", rand_field((WIDTH, 1))),
                            ("scalar", rand_field((1, 1)))):
            for label, fn in variants[:2]:
                ck._operand = fn
                single[f"{what}_{label}_ms"] = round(
                    cuda_ms(lambda: ck.gl_mul(full, small), 2, 10), 4)
        del full
        ck._operand = in_kernel
        phase("compare_broadcast", log_n=args.log_n, width=WIDTH, runs=runs,
              gl_mul_ms=single)

    # -- 6. the kernels line --------------------------------------------------
    def entry(name, source, replaces):
        t = timing[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None}

    gsrc = "zkevm_harness_tpu_torch/csrc/goldilocks.cu"
    kernels_line = {
        "kernels": [
            entry("gl_mul", gsrc,
                  "zkevm_harness_tpu/ops/pallas_kernels.py:386"),
            entry("poseidon2_permute",
                  "zkevm_harness_tpu_torch/csrc/poseidon2.cu",
                  "zkevm_harness_tpu/ops/pallas_kernels.py:255")],
        # elementwise helpers on the same device routines; they port no TPU
        # kernel
        "helpers": [entry(n, gsrc, None)
                    for n in ("gl_add", "gl_sub", "gl_pow7")]}
    records.append(kernels_line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"records": records,
                       "total_s": round(time.time() - t_start, 1)}, f,
                      indent=1)
    print(smi, flush=True)
    emit(kernels_line)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
