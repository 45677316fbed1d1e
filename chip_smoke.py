#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # full run: flagship 130 x 2^19, one
                                     # MainVM instance 764 x 2^16, the
                                     # block's RAM permutation, sorters and
                                     # log demuxer, the hash block's hash
                                     # circuits, the whole block's 13 base
                                     # types at production geometry, then
                                     # its full chain over the tower of all
                                     # 13 (leaf arity 2): tower,
                                     # a blob, compression for the wrapper
                                     # and the "binding" SNARK, then mode
                                     # 1 at LDE 32 and the "pi" SNARK;
                                     # the CLI, the AIR STARK engine, the
                                     # gadget circuits; the column-sharded
                                     # prove and the distributed NTT in
                                     # ranks of torch.distributed
    python3 chip_smoke.py --log-n 16 # flagship with fewer rows (same width)

It needs one CUDA card and exits non-zero without one. It imports nothing of
JAX and nothing of the JAX package. Phases, one JSON object per line:

  1. device    card name and power limit (nvidia-smi), torch/CUDA versions
  2. build     nvcc build of every kernel under zkevm_harness_tpu_torch/csrc
  3. kernels   each kernel against its plain PyTorch version on the card,
               bit for bit (integers: tolerance 0), and timed with CUDA
               events at the shapes of both main paths
  4. golden    the golden circuit (log_n 6, width 8, seed 42) proved on the
               card equals test_artifacts/flagship_log6_{vk,proof}.json
  5. main      flagship circuit at full width: setup, witness, prove, verify,
               three tampered proofs rejected; launch counters read
  6. paths     the unstratified quotient and the retained-LDE schedule, each
               proved at the golden shape: equal to the golden proof
  7. main_vm_golden  the small MainVM instance of
               zkevm_harness_tpu_torch/golden.py proved on the card equals
               test_artifacts/main_vm_log8_{vk,proof}.json
  8. main_vm   one real MainVM instance at full size (5585 cycles traced by
               the out-of-circuit VM, u16 x 16 limbs, 2^16 rows, 50 queries):
               trace, artifacts, witness, setup, prove twice, verify, public
               inputs as expected, three tampered proofs rejected; launch
               counters of this phase alone; with --out, the proof, its VK
               and a summary written into main_vm_production/ beside that
               file (test_artifacts/main_vm_production_*, judged by the JAX
               package's verifier in tests/test_torch_tower13.py)
  9. sorters_golden  the first instance of each memory and log circuit of
               the golden block (RAM permutation, events sorter, storage
               sorter, log demuxer) proved on the card equals
               test_artifacts/{ram,events,storage,demux}_log8_{vk,proof}.json
 10. sorters   the 5585-cycle block's memory and log subsystem at production
               geometry (GeometryConfig() capacities, 50 queries): the
               production VKs of types 8, 11, 12, 9 and 4 equal
               setup/setup/base_layer/vk_N.json (type 4's under its leaf
               in `tower13`); the block's one instance of
               each of types 8, 11, 9 and 4 is decomposed (the proofs at
               this geometry are phase `tower13`'s); launch counters of
               this phase
  11. hashes_golden  the first instance of each hash circuit of the small
               hash block (keccak 5, SHA-256 6, L1-messages hasher 13, code
               decommitter 3, decommitments sorter 2) proved on the card
               equals test_artifacts/{name}_log{7,8}_{vk,proof}.json
  12. hashes   the 293-round hash block (far calls to four deployed
               callees, keccak and SHA-256 precompile calls, L1 messages) at
               production geometry: the production VKs of types 2, 3, 6 and
               13 equal setup/setup/base_layer/vk_N.json (type 5's digest
               printed); every instance of types 5, 6, 13, 3 and 2
               decomposed, the instance of 6 (HASHES_PROVED) proved,
               verified, public inputs checked and tampered copies rejected
               (types 13, 3, 2 and 5 are
               proved at this geometry in phase `tower13`); the digests on
               the public inputs (the hasher's
               is keccak256 of the L1 messages, the first decommitter's the
               SHA-256 in its versioned hash, the round functions' final
               accumulators in the last PI lanes); launch counters of this
               phase
  13. kernels_hashes  gl_mul and poseidon2_permute against their plain
               versions and timed at the hash path's shapes
  14. block_golden  the golden ecrecover (type 7, toy curve) and
               storage-application (type 10, depth 4) proofs made on the
               card equal test_artifacts/{ecrecover_toy,storage_app_d4}_*
  15. block_artifacts, block  the whole block (golden.WHOLE_BLOCK: loop
               bodies, hash rounds, far calls, 7 ecrecover calls; 880
               cycles) through witness.oracle.create_artifacts_from_tracer at
               GeometryConfig(): every one of the 13 base types has an
               instance; the storage roots chain from the artifacts' initial
               to their final root; storage application (type 10, depth 256,
               BLOCK_PROVED) has the first query's read path (phase
               `tower13` chains all 18 paths' roots) proved and verified at
               production geometry through
               layers.prove_base_instance, its public inputs the expected
               ones, its VK equal to test_artifacts/vk_10_production.json,
               proved twice to equal bytes and tampered copies rejected;
               launch counters of this phase (every instance of
               every type, the log demuxer's too, is proved in `tower13`)
  16. kernels_block  gl_mul and poseidon2_permute against their plain
               versions and timed at the new circuits' shapes
  17-19b. the golden towers, in two processes of their own on the card
               that run beside phases 24-31 (they time nothing, and those
               time no kernel of the kernels line), their records printed
               when the processes end, with `background` and the seconds
               into their process:
  17. tower_golden  the JAX package's golden tower (the RAM permutation of
               golden.tower_block at testing geometry, rate 2, cap 4, 2
               queries) through harness.run_block(tower=True) on the card:
               the leaf, node and scheduler VKs and proofs equal
               test_artifacts/tower_golden_*.json
  18. wrap_golden  made on the card, equal to the JAX package's bytes
               (tools/gen_wrap_golden.py): the five-mode compression chain
               over the queue_ir(5) stand-in; compression mode 1 at its
               production config (LDE 32) over the golden tower's scheduler
               proof; the "pi" SNARK proof of that scheduler's public
               inputs; the EIP-4844 witness chain, blob-circuit VK and proof
               at the 16-element testing domain; the full chain over
               golden.tower_block with that blob in the scheduler's blob
               slot (scheduler VK and proof, mode 1, SNARK proof equal
               test_artifacts/wrap_blob_*); mode proofs with an inner
               public input changed refused by the STARK verifier; the
               native MSMs ran
  19. fw_golden  made on the card, equal to the JAX package's bytes
               (tools/gen_fw_golden.py): the queue_ir(5) stand-in's
               for-wrapper proof (Poseidon2-BN254 trees and transcript, Fr
               VK), the "full" SNARK statement over it (selectors, wiring,
               public gates and assignment digests equal
               test_artifacts/fw_full_statement.json, every gate holding),
               compression mode 1 for the wrapper over the golden tower's
               scheduler and the "binding" SNARK over its Fr VK; a changed
               public input, cap digest, OOD value and opening refused by
               both the STARK verifier and the statement's gate check; K3
               launched
  19b. tower13_golden  the JAX package's golden tower of the small whole
               block (golden.WHOLE_GOLDEN at testing geometry, rate 2, cap
               4, 2 queries) over types 1-6, 9 and 11-13 through
               harness.run_block(tower=True) in one process on the card:
               every base, leaf, node and scheduler VK and proof and the
               scheduler's public inputs equal test_artifacts/tower13_*
               (tools/gen_tower13_golden.py); then storage application's
               golden tower (golden.TYPE10_GOLDEN: one storage write, its
               read and write paths at depth 4 in one leaf of arity 2, a
               node, the scheduler) through harness.run_block(tower=True,
               leaf_arity=2): equal to test_artifacts/tower10_*
               (tools/gen_type10_golden.py)
  20. tower    the whole block's full chain through
               full_chain.prove_block_full_chain at GeometryConfig() and
               leaf_arity=golden.TOWER_LEAF_ARITY (2): base, leaf and node
               proofs of all 13 types (TOWER13_TYPES: type 10's 18 paths in
               9 leaves and a node over them, type 3's 4 instances in 2, the
               log demuxer's 2^23-row leaf) and the scheduler over their 13
               slots at production
               parameters (rate 2, cap 16, 50 queries, final FRI size 512),
               the types' base, leaf and node tasks in three processes on
               the card (`type_workers`), the scheduler verifying one
               496-byte blob's fold proof (KzgSettings.testing(16), its
               final FRI size 256 so that it folds) in a slot after the
               types', then compression mode 1 for the wrapper (rate 2, cap
               16, 40 queries, final 32; trees and transcript Poseidon2
               over BN254 Fr, the trees on K3) and the "binding" BN254
               PLONK wrapper over its Fr VK; then a second wrap of the same
               scheduler proof, compression mode 1 at LDE 32 and the "pi"
               wrapper; each proof verified with its expected public
               inputs; each leaf's tail is its queue segment's tail, the
               last leaf's its type's recursion-queue tail; the scheduler
               proved a second time from its witness to equal bytes; a
               tampered leaf proof leaves gates of the node of type 7
               unsatisfied, a tampered scheduler public input fails verify,
               and the keccak base proof (type 5) with a public input or an
               OOD value changed is refused by its base verifier; the block
               commitment binds the blob's output hash; mode 1's public
               inputs are the scheduler's VK and public inputs, and with
               one of the scheduler's public inputs changed the STARK
               verifier refuses it (both modes); the SNARKs' public input
               packs the scheduler's and a wrong one (or another
               for-wrapper VK) is refused; with --out, the for-wrapper
               proof, its VK and a summary written into fw_production/
               beside that file, and the first production leaf of types 10
               and 4 into leaf_production/; the seconds, peak memory and
               launches of
               the scheduler and of every wrap proof; with --profile the
               chain once more under the profiler for the device's idle
               share
  20b. tower13  that chain's tower task by task: per base, leaf and node
               proof of each type and for the scheduler its shape, the
               seconds of synthesis, finalize, fill, setup, prove, verify
               and of waiting for the card, its peak memory, its K1 and K2
               launches and its process's peak host RSS, beside the card's
               name and power limit; per leaf the running peak memory at
               the end of each prover stage; the largest leaf (the log
               demuxer's 2^23 x 48) apart and the 2^22-row leaves' peaks;
               each worker's types and peak RSS; each type's leaves cover
               its instances and its node its leaves; the base VK under
               each leaf equal to the committed production VK; type 10's
               18 path proofs chain the storage roots; a tampered scheduler
               public input refused
  21. eip4844  the blob circuit at full width (4,096 elements, u8 limbs)
               at the chain's base config, elements and point from a seed:
               setup, prove, verify with the expected public inputs; the
               STARK verifier refuses the public inputs of a tampered
               element and opening value, and a tampered OOD value
  22. kernels_tower, kernels_tower13, kernels_wrap  gl_mul and
               poseidon2_permute against their plain versions and timed at
               the tower's shapes, at each new leaf shape of `tower13` (its
               columns over its rows, and the largest leaf's over its
               commitment domain: (48, 2^23) and (48, 2^24); that leaf's
               2^24 commitment leaves for the permutation),
               at compression mode 1's LDE and at the 4,096-element blob
               circuit's
  23. kernels_fw  K3 (bn254_hash_rows, bn254_hash_pairs) against its plain
               version (exact Python ints) at 1,024 rows of mode 1's 72
               columns and 2,048 pairs, at rows of Goldilocks p - 1 (widths
               72, 7, 1), at pairs of Fr p - 1 and at 40 pairs; timed at the
               production for-wrapper tree's 2^18 rows and 2^17 pairs beside
               the work bound (32-bit multiplies the algorithm needs) and
               the first design's times, the tree's whole commitment (cap
               16) in total and per level, and the verifier's 40-path level;
               ptxas' registers and spills of both kernels
  24. cli_golden  the port's CLI (python -m zkevm_harness_tpu_torch), each
               command a process of its own on the card, five side by side:
               `prove --log-n 8 --width 16` writes the JAX CLI's file byte
               for byte, `verify` prints VALID on it (exit 0) and INVALID on
               a tampered copy (exit 1), `geometry` and `geometry
               --measured` print the JAX CLI's JSON, `generate-vks --types 8
               --recursion` writes its VKs, `prove-block --types 8` its
               scheduler, compression and SNARK proofs and block commitment
               (test_artifacts/cli_*, tools/gen_cli_golden.py)
  25. cli      the CLI at full width: `prove` of the flagship (130 x
               2^log_n, the CLI's config); then, three processes side by
               side, `verify`, `verify` of a tampered copy (refused) and
               `generate-vks
               --geometry production --types 1,5,7,10`, each VK equal to
               test_artifacts/vk_N_production.json; `bench-kernels`; wall
               seconds of each process and the launches of all but the
               bench
  26. stark_golden, stark  the fib-mul AIR through the AIR STARK engine:
               at log_n 6 equal to test_artifacts/stark_fib_log6_proof.json;
               at 2^20 rows under StarkConfig() proved, verified, a tampered
               OOD value, opening and trace refused; stage seconds,
               `_zh_over_last_inv` on the card and in host ints, launches,
               peak memory
  27. gadgets_golden  the five gadget circuits (GF(p^2) chain, inverse
               cells, FRI fold, transcript, Merkle path) made on the card,
               VKs and proofs equal test_artifacts/gadget_*
  28. ref_serde  the main path's flagship proof through the reference's
               JSON dialect and back verifies; key sets as the reference's
  29. mesh_golden  proving across cards (parallel/), 4 ranks of
               parallel.mesh.run_on_mesh (gloo with every rank on card 0
               where the machine has fewer cards than ranks, nccl with a
               card a rank where it has enough): the five sharded helpers
               at tests/test_mesh.py's shapes equal the one-rank functions,
               distributed_ntt at (3, 1024) equals ntt, and
               prove_column_sharded of the flagship at log_n 6, width 16
               equals test_artifacts/mesh_log6_w16_proof.json and verifies
  30. mesh_dryrun  the JAX package's multi-chip dry run at D = 4 (in the
               same spawn): sharded commit step (width 8, 128 rows),
               distributed NTT (2, 256), prove_column_sharded of the
               flagship 2^9 x 64 (rate 2, cap 8, 8 queries, final 16) equal
               to test_artifacts/mesh_log9_w64_proof.json, verified, caps
               and query positions equal to a one-rank prove's; both times
  31. mesh     prove_column_sharded of the main path's flagship (130 x
               2^log_n, its config) over 2 ranks, twice, equal to phase
               main_path's proof byte for byte, verified, a tampered public
               input refused; distributed_ntt of (130, 2^20) over 4 ranks
               equal to ntt. Each of 29-31 prints backend, ranks and cards,
               the collective bytes a rank sent per prover phase, per-rank
               seconds and peak memory, and the launches of the sharded
               work (path `mesh` of the kernels line)
  32. kernels  one line {"kernels": [...], "helpers": [...]}; K3's entries
               replace no TPU kernel (`replaces` names the JAX package's
               host Python hash they take over, `tpu_kernel` is null)

The last line is {"ok": true, "device": {...}}. Any failed phase raises and
the run exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import json
import multiprocessing
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time

from zkevm_harness_tpu_torch.utils.kernel_bench import (
    OPS_ADD, OPS_MUL, P2_ADDS, P2_MULS, PEAK_BYTES_PER_S, PEAK_INT_ALU_PER_S,
    bn254_bound_ms, bn254_permutation_insns, nvidia_smi_line)

WIDTH = 130  # the flagship's MainVM-shaped trace width; never cut
MAIN_VM_CYCLES = 5585  # cycles per MainVM instance (cycles_per_vm_snapshot)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO_DIR, "test_artifacts")
PROD_VK_DIR = os.path.join(REPO_DIR, "setup", "setup", "base_layer")

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def pi_bumped(proof, k=0):
    """A copy of `proof` with its public input k changed."""
    bad = copy.deepcopy(proof)
    bad.public_inputs[k] = (int(bad.public_inputs[k]) + 1) % GOLDILOCKS_P
    return bad


def ood_bumped(proof):
    """A copy of `proof` with one witness OOD value changed."""
    bad = copy.deepcopy(proof)
    c0, c1 = bad.ood_witness[3]
    bad.ood_witness[3] = ((int(c0) + 1) % GOLDILOCKS_P, c1)
    return bad


def main_vm_block(golden, isa):
    """The full-size MainVM workload: a 5585-cycle block, 697 rounds of the
    eight-instruction loop body (arithmetic, division, heap, storage, event),
    then Nops up to the final Ret."""
    prog = golden.loop_body(isa) * 697
    return prog + [isa.Nop()] * (MAIN_VM_CYCLES - 1 - len(prog)) + [isa.Ret()]


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


def sass_dynamic_counts(sass_path, func_part, trips):
    """Integer-ALU instructions (IMADs apart) and IMADs that one thread of
    the kernel whose name contains `func_part` executes, from its SASS: an
    instruction inside loops (a backward branch and its target) counted once
    per trip of each loop around it, `trips` giving the loops' trip counts
    in the order of their first instruction (an outer loop before the loop
    it holds), the rest once. None when the kernel has another number of
    loops, or loops that overlap without nesting."""
    alu = ("IADD3", "ISETP", "SEL", "LOP3", "SHF", "IADD", "VIADD", "LEA",
           "PLOP3", "P2R", "R2P", "PRMT", "IMNMX", "IABS", "POPC", "FLO")
    with open(sass_path) as f:
        text = f.read()
    body = next(part for part in text.split("Function :")[1:]
                if func_part in part.split("\n", 1)[0])
    ins = []
    for line in body.splitlines():
        line = line.strip()
        parts = line.split("*/", 1)
        if not line.startswith("/*") or len(parts) < 2:
            continue
        words = parts[1].strip().split()
        if not words or words[0].startswith("/*"):
            continue
        pred = words[0].startswith("@")
        op = (words[1] if pred else words[0]).rstrip(";").split(".")[0]
        target = None
        if op == "BRA":
            target = int((words[2] if pred else words[1]).rstrip(";"), 16)
        ins.append((int(parts[0][2:], 16), op, target))
    loops = sorted(((t, a) for a, op, t in ins if t is not None and t < a),
                   key=lambda lh: (lh[0], -lh[1]))
    if len(loops) != len(trips):
        return None
    for (lo1, hi1), (lo2, hi2) in zip(loops, loops[1:]):
        if lo2 <= hi1 < hi2:
            return None
    counts = {"alu": 0, "imad": 0}
    for addr, op, _t in ins:
        kind = "imad" if op == "IMAD" else "alu" if op in alu else None
        if kind:
            mult = 1
            for (lo, hi), trip in zip(loops, trips):
                if lo <= addr <= hi:
                    mult *= trip
            counts[kind] += mult
    return counts


def device_rows(fn, host_too=True):
    """Run fn under torch.profiler; (wall seconds, device-side rows).
    `host_too=False` records the device's activity alone, which keeps
    the trace of a run with very many launches small."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_too:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=activities) as prof:
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


def block_phases(args, dev, phase, rand_field, check_equal, cuda_ms, errs):
    """Phases `block_golden`, `block` and `kernels_block`: the golden
    ecrecover (7) and storage-application (10) proofs on the card, then one
    whole block through `create_artifacts_from_tracer` at `GeometryConfig()`
    with every base type's instances counted, the storage roots chained and
    the first storage query's read and write paths (`BLOCK_PROVED`) proved,
    verified, proved again and tampered (every instance of every type is
    proved in the tower), then K1 and K2 against their plain versions and
    timed at the new circuits' shapes. Returns (the block path's launches,
    its kernel timings)."""
    import torch

    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import ecrecover_circuit as eccirc
    from zkevm_harness_tpu_torch.circuits import ffarith as ffmod
    from zkevm_harness_tpu_torch.circuits import \
        storage_application_circuit as sappcirc
    from zkevm_harness_tpu_torch.circuits.types import GeometryConfig
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde, tracing
    from zkevm_harness_tpu_torch.witness import oracle

    P = gl.P
    scfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    bcfg = pk.PlonkishConfig(rate=2, cap_size=16, num_queries=50,
                             final_fri_size=512)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def golden_json(name):
        with open(os.path.join(GOLDEN_DIR, name)) as f:
            return json.load(f)

    def same_proof(proof, name):
        return json.loads(json.dumps(serde.proof_to_json(proof))) == \
            golden_json(name)

    # -- block_golden: the golden proofs of types 7 and 10 on the card ------
    t0 = time.time()
    golden_s = {}
    eprog = eccirc.build_ecrecover_program(
        eccirc.CurveParams(**golden.ecrecover_toy_curve()))
    eir, esetup = ffmod.ff_setup(eprog.layout, scfg, device=dev)
    h, r, s, q, ry = golden.ecrecover_toy_signature()
    eproof, golden_s["ecrecover"] = timed(lambda: pk.prove(
        eir, esetup, eccirc.ecrecover_witness(eprog, eir, h, r, s, q, ry,
                                              device=dev), scfg, device=dev))
    if esetup.vk() != golden_json("ecrecover_toy_vk.json") or \
            not same_proof(eproof, "ecrecover_toy_proof.json"):
        raise SystemExit("block_golden: the toy ecrecover VK or proof "
                         "differs from the golden JSON")
    if not pk.verify(eir, esetup.vk(), eproof, scfg, device=dev):
        raise SystemExit("block_golden: the toy ecrecover proof does not "
                         "verify")
    del eprog, eir, esetup, eproof
    path = sappcirc.PathInstanceInputs(
        golden.STORAGE_APP_LEAF, list(golden.STORAGE_APP_PATH_BITS),
        list(golden.STORAGE_APP_SIBLINGS))
    stem = f"storage_app_d{golden.STORAGE_APP_DEPTH}"
    with ly.engine_override(scfg):
        sproof, golden_s["storage_application"] = timed(
            lambda: ly.prove_storage_application_path(path, device=dev))
        ssd, _ = ly.storage_application_setup_data(
            depth=golden.STORAGE_APP_DEPTH, device=dev)
        if ssd.vk != golden_json(stem + "_vk.json") or \
                not same_proof(sproof, stem + "_proof.json"):
            raise SystemExit("block_golden: the depth-4 storage-application "
                             "VK or proof differs from the golden JSON")
        if not ly.verify_storage_application_path(path, sproof, device=dev):
            raise SystemExit("block_golden: the depth-4 path proof does not "
                             "verify")
    del ssd, sproof
    ly._SETUP_CACHE.clear()
    phase("block_golden", curve="toy (61-bit field, 64-bit scalars, u8)",
          depth=golden.STORAGE_APP_DEPTH, vk_equal=True, proof_equal=True,
          verify=True, seconds={k: round(v, 3) for k, v in golden_s.items()},
          total_s=round(time.time() - t0, 3))

    # -- block: the whole block, all 13 base types ------------------------------
    geo = GeometryConfig()
    (tracer, pre_state), trace_s = timed(
        lambda: golden.trace_whole_block(**golden.WHOLE_BLOCK))
    n_ecrecover = sum(1 for (_, q_, _d, _r) in tracer.precompile_calls
                      if q_.address == golden.ECRECOVER_ADDRESS)
    if n_ecrecover != golden.WHOLE_BLOCK["ecrecover_calls"]:
        raise SystemExit(f"block: {n_ecrecover} ecrecover calls traced")
    tracing.GLOBAL.enabled = True
    tracing.GLOBAL.sync = torch.cuda.synchronize
    tracing.GLOBAL.spans.clear()
    ck.reset_launches()
    t_path = time.time()
    art, artifacts_s = timed(lambda: oracle.create_artifacts_from_tracer(
        tracer, geo, initial_storage=pre_state, device=dev))
    per_decomposer = {k.split(".", 1)[1]: round(v, 3) for k, v in
                      tracing.GLOBAL.flat_durations().items()
                      if k.startswith("oracle.")}
    payloads = oracle.block_payloads(art, geo)
    counts = {t: len(insts) for t, (insts, _c, _cap) in payloads.items()}
    if sorted(counts) != list(range(1, 14)) or min(counts.values()) < 1:
        raise SystemExit(f"block: not every base type has an instance: "
                         f"{counts}")
    phase("block_artifacts", block=golden.WHOLE_BLOCK,
          cycles=tracer.cycle_counter, trace_s=round(trace_s, 3),
          artifacts_s=round(artifacts_s, 3), per_decomposer_s=per_decomposer,
          instances=counts,
          per_circuit={t: a.num_instances for t, a in
                       art.per_circuit.items()})
    # the storage roots: the read path of the first query opens the initial
    # root, each query's write path the root the next query's read opens,
    # the last write the final root
    sa = art.storage_application
    depth = geo.storage_tree_depth
    g10 = sappcirc.PathGeometry(depth=depth)
    roots = [sa.initial_root]
    for rd, wr in sa.instances:
        if sappcirc.root_bytes(g10, sappcirc.expected_public_inputs(
                g10, rd)) != roots[-1]:
            raise SystemExit("block: a storage read path does not open the "
                             "root before it")
        roots.append(sappcirc.root_bytes(
            g10, sappcirc.expected_public_inputs(g10, wr)))
    if roots[-1] != sa.final_root:
        raise SystemExit("block: the last storage write does not give the "
                         "final root")

    def prove_stages(durations):
        return {k: round(v, 4) for k, v in durations.items()
                if k.startswith("plonkish.prove")}

    def bump_pi(p):
        p.public_inputs[0] = (p.public_inputs[0] + 1) % P

    def bump_ood(p):
        c0, c1 = p.ood_witness[3]
        p.ood_witness[3] = ((c0 + 1) % P, c1)

    committed = {2, 3, 4, 6, 8, 9, 11, 12, 13}
    per_type = {}
    with ly.engine_override(bcfg):
        for ctype in (7, 10, 1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 13):
            if ctype not in BLOCK_PROVED:
                # every instance proved, and its VK checked, in `tower13`
                per_type[ctype] = {"instances": counts[ctype],
                                   "proved_in": "tower13"}
                continue
            insts, ch, cap = payloads[ctype]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(ck.LAUNCHES)
            sd, setup_s = timed(lambda: ly.base_setup_for_type(
                ctype, geo, device=dev))
            # 2-4, 6, 8, 9, 11-13 under setup/, 1, 5, 7 and 10 in
            # test_artifacts/ (tools/gen_block_golden.py, gen_cli_golden.py)
            vk_file = (os.path.join(PROD_VK_DIR, f"vk_{ctype}.json")
                       if ctype in committed else os.path.join(
                           GOLDEN_DIR, f"vk_{ctype}_production.json"))
            rec = {"log_n": sd.ir.log_n, "width": sd.ir.num_witness,
                   "const_cols": sd.ir.num_const,
                   "gate_constraints": sd.ir.num_gate_constraints,
                   "gate_degree": sd.ir.gate_degree,
                   "lookup_sets": len(sd.ir.lookup_sets),
                   "instances": len(insts),
                   "vk_sha256": hashlib.sha256(",".join(
                       str(int(v)) for v in sd.vk).encode()).hexdigest(),
                   "setup_s": round(setup_s, 3)}
            with open(vk_file) as f:  # a missing file fails the run
                if sd.vk != [int(v) for v in json.load(f)]:
                    raise SystemExit(f"block: the production VK of type "
                                     f"{ctype} differs from {vk_file}")
            rec["vk_equal"] = os.path.relpath(vk_file, REPO_DIR)
            # type 10: the first query's read path (phase `tower13` chains
            # every path's root)
            todo = insts[:1]
            for k, inst in enumerate(todo):
                prove = lambda: ly.prove_base_instance(  # noqa: E731
                    ctype, inst, ch, cap, device=dev)
                verify = lambda pr: ly.verify_base_instance(  # noqa: E731
                    ctype, inst, ch, cap, pr, device=dev)
                tracing.GLOBAL.spans.clear()
                before_prove = dict(ck.LAUNCHES)
                proof, prove_s = timed(prove)
                spans = tracing.GLOBAL.flat_durations()
                sub = {"prove_s": round(prove_s, 3),
                       "witness_fill_s": round(spans.get("layers.witness",
                                                         0.0), 3),
                       "launches_one_prove": {
                           kk: ck.LAUNCHES[kk] - before_prove[kk]
                           for kk in ck.LAUNCHES},
                       "stages_s": prove_stages(spans)}
                ok, verify_s = timed(lambda: verify(proof))
                if not ok:
                    raise SystemExit(f"block: type {ctype} does not verify")
                want = [int(v) % P for v in ly.real_base_instance_public_inputs(
                    ctype, inst, ch, cap)]
                if [int(v) for v in proof.public_inputs] != want:
                    raise SystemExit(f"block: type {ctype}: public inputs are "
                                     "not the expected ones")
                sub.update(verify_s=round(verify_s, 3), public_inputs=len(want))
                if ctype == 10 and k == 0:
                    again, warm_s = timed(prove)
                    if serde.proof_to_json(again) != \
                            serde.proof_to_json(proof):
                        raise SystemExit(f"block: type {ctype}: a second "
                                         "prove gave a different proof")
                    del again
                    bad_pi, bad_ood = copy.deepcopy(proof), copy.deepcopy(proof)
                    bump_pi(bad_pi)
                    bump_ood(bad_ood)
                    tamper = {"public_input": not verify(bad_pi) and not
                              pk.verify(sd.ir, sd.vk, bad_pi, sd.config,
                                        device=dev),
                              "ood_witness": not verify(bad_ood)}
                    if not all(tamper.values()):
                        raise SystemExit(f"block: type {ctype}: a tampered "
                                         f"proof was accepted: {tamper}")
                    sub.update(prove_warm_s=round(warm_s, 3),
                               second_proof_equal=True,
                               tampered_rejected=tamper)
                    if args.profile:  # as in phase `sorters`
                        counted = dict(ck.LAUNCHES)
                        _, rows = device_rows(prove, host_too=False)
                        ck.LAUNCHES.update(counted)
                        busy_s = sum(r_[2] for r_ in rows) / 1e6
                        sub.update(device_busy_s=round(busy_s, 3),
                                   device_idle_share=round(
                                       1 - busy_s / warm_s, 3))
                if ctype == 10:
                    # the read path opens the initial root, the write path
                    # the root after the first query
                    which = ("read", "write")[k]
                    got = sappcirc.root_bytes(g10, proof.public_inputs)
                    if got != roots[k]:
                        raise SystemExit(f"block: the {which} path's root is "
                                         "not the artifacts' root")
                    sub["root"] = got.hex()
                    rec[which] = sub
                else:
                    rec.update(sub)
                del proof
            rec.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                       launches={kk: ck.LAUNCHES[kk] - before[kk]
                                 for kk in ck.LAUNCHES}, verify=True,
                       public_inputs_as_expected=True)
            per_type[ctype] = rec
            del sd
            ly._SETUP_CACHE.clear()
    launches_block = dict(ck.LAUNCHES)
    tracing.GLOBAL.enabled = False
    for name in ("gl_mul", "poseidon2_permute"):
        if launches_block[name] <= 0:
            raise SystemExit(f"block path launched {name} no time")
    torch.cuda.empty_cache()
    phase("block", block=golden.WHOLE_BLOCK,
          config={"rate": bcfg.rate, "cap_size": bcfg.cap_size,
                  "num_queries": bcfg.num_queries,
                  "final_fri_size": bcfg.final_fri_size},
          initial_root=sa.initial_root.hex(), final_root=sa.final_root.hex(),
          storage_queries=len(sa.instances),
          path_s=round(time.time() - t_path, 3), launches=launches_block,
          types=per_type)

    # -- kernels_block: K1 and K2 at the new circuits' shapes -------------------
    # the stacked (columns, rows) of a type-7 (286 x 2^16) and a type-10
    # (2,609 x 2^12) coset for the multiply; the 2^17 leaves of the type-7
    # rate-2 commitment for the permutation
    timing_block = {}
    for label, shape in (("gl_mul_ecrecover", (286, 1 << 16)),
                         ("gl_mul_storage_application", (2609, 1 << 12))):
        ta, tb = rand_field(shape), rand_field(shape)
        errs["gl_mul"] = max(errs["gl_mul"], check_equal(
            "gl_mul block shape", ck.gl_mul(ta, tb), ck.gl_mul_plain(ta, tb)))
        timing_block[label] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: ck.gl_mul(ta, tb), 2, 10),
            "plain_ms": cuda_ms(lambda: ck.gl_mul_plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * ta.numel(), "ops": ta.numel() * OPS_MUL}
        del ta, tb
    states = 1 << 17
    ts = rand_field((states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 block shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing_block["poseidon2_permute"] = {
        "shape": [states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * states,
        "ops": states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    for t in timing_block.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_block", tolerance=0,
          max_abs_err={k: errs[k] for k in ("gl_mul", "poseidon2_permute")},
          timing={k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                      for kk, vv in t.items()}
                  for k, t in timing_block.items()})
    return launches_block, timing_block


def golden_tower_phases(dev, phase):
    """Phases `tower_golden`, `wrap_golden` and `fw_golden`: the golden
    tower of type 8 through the port's `harness.run_block(tower=True)` on
    the card, equal to the JAX package's bytes, and the compression, SNARK,
    blob and for-wrapper goldens over it. Returns fw_golden's launches."""
    from zkevm_harness_tpu_torch import golden, harness
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import native, serde
    from zkevm_harness_tpu_torch.vm import isa

    golden_json = _golden_json

    def rounded(stats):
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in stats.items()}

    def task_name(key):
        kind, ctype, depth, index = key
        if kind == "leaf":
            ctype -= 2  # the base type the leaf aggregates
        return f"{kind}_{ctype}" if kind != "scheduler" else kind

    # -- tower_golden: the JAX package's golden tower, made on the card -------
    gcfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    t0 = time.time()
    with ly.engine_override(gcfg):
        gres = harness.run_block(golden.tower_block(isa), prove_mode="spot",
                                 spot_types=(8,), tower=True,
                                 recursion_cfg=gcfg, device=dev)
    gsrc = gres.source
    for name, rec in (("leaf", gsrc.get_leaf_layer_proof(10, 0)),
                      ("node", gsrc.get_node_layer_proof(8, 0, 0)),
                      ("scheduler", gsrc.get_scheduler_proof())):
        if not rec or not rec.get("real"):
            raise SystemExit(f"tower_golden: no real {name} proof")
        if [int(v) for v in rec["vk"]] != golden_json(
                f"tower_golden_{name}_vk.json") or \
                json.loads(json.dumps(serde.proof_to_json(rec["proof"]))) != \
                golden_json(f"tower_golden_{name}_proof.json"):
            raise SystemExit(f"tower_golden: the {name} VK or proof differs "
                             "from the golden JSON")
    phase("tower_golden", config=golden.TOWER_GOLDEN_CONFIG, spot_types=[8],
          vk_equal=True, proof_equal=True, verify=True,
          tasks={task_name(k): rounded({kk: vv for kk, vv in v.items()
                                        if kk != "launches"})
                 for k, v in gres.tower_stats.items()},
          total_s=round(time.time() - t0, 3))

    # -- wrap_golden: compression, the "pi" SNARK and the blob branch ---------
    if not native.have_native() or not native.have_msm():
        raise SystemExit("the native library or its MSM did not load")
    wrap_golden_phase(dev, phase, gres, gcfg, golden_json, rounded)
    launches_fw = fw_golden_phase(dev, phase, gres, gcfg, golden_json,
                                  rounded)
    return launches_fw


def tower_phases(args, dev, phase, rand_field, check_equal, cuda_ms, errs):
    """Phases `tower`, `tower13`, `eip4844` and the kernel phases after
    them: the whole block's full chain at production parameters (base,
    leaf and node proofs of all 13 types, the scheduler, the wrap, each
    verified); then K1 and K2 (and K3) against their plain versions and
    timed at the chain's shapes. Returns (the paths' launches, their
    kernel timings)."""
    import numpy as np
    import torch

    from zkevm_harness_tpu_torch import full_chain as fc
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import node_circuit as nc
    from zkevm_harness_tpu_torch.circuits import scheduler_circuit as sc_circ
    from zkevm_harness_tpu_torch.circuits.types import (GeometryConfig,
                                                        leaf_for)
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import compression as cmp
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.prover import scheduler as sch
    from zkevm_harness_tpu_torch.utils import kzg, native, serde, tracing
    from zkevm_harness_tpu_torch.utils import snark_wrapper as sw
    from zkevm_harness_tpu_torch.vm import isa
    from zkevm_harness_tpu_torch.witness import oracle

    P = gl.P

    def rounded(stats):
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in stats.items()}

    def task_name(key):
        kind, ctype, depth, index = key
        if kind == "leaf":
            ctype -= 2  # the base type the leaf aggregates
        return f"{kind}_{ctype}" if kind != "scheduler" else kind

    # -- tower: the whole block's full chain at production parameters -------
    bcfg = pk.PlonkishConfig(**golden.TOWER_CONFIG)
    geo = GeometryConfig()
    code = golden.whole_block(isa, **golden.WHOLE_BLOCK)
    contracts = dict(golden.hash_callees(isa,
                                         golden.WHOLE_BLOCK["callee_reps"]))
    # the chain's tower is the whole block's over all 13 types (phase
    # `tower13` reports it task by task)
    spot = TOWER13_TYPES
    settings = kzg.KzgSettings.testing(16)
    blob = bytes(np.random.default_rng(4844).integers(
        0, 256, size=31 * 16, dtype=np.uint8))
    # the 16-element blob is a 2^8-row circuit, whose 512-point LDE a final
    # FRI size of 512 does not fold: its proof folds once to 256
    blob_cfg = dataclasses.replace(bcfg, final_fri_size=256)
    msm_before = dict(native.MSM_CALLS)

    def run_chain():
        with _worker_allocator():
            return fc.prove_block_full_chain(
                code, chain_types=spot, geometry=geo, base_cfg=bcfg,
                recursion_cfg=bcfg, compression_layers=1,
                contracts=contracts, for_wrapper=True, snark_mode="binding",
                blobs=[blob], blob_kzg_settings=settings, blob_cfg=blob_cfg,
                leaf_arity=golden.TOWER_LEAF_ARITY,
                type_workers=TOWER13_WORKERS, device=dev)

    ck.reset_launches()
    t_path = time.time()
    chain = run_chain()
    torch.cuda.synchronize()
    chain_s = time.time() - t_path
    # this process's launches and those of the processes that proved the
    # types' subtrees
    launches_tower = {k: v + chain.block.worker_launches.get(k, 0)
                      for k, v in ck.LAUNCHES.items()}
    for name in ("gl_mul", "poseidon2_permute", "bn254_hash_rows",
                 "bn254_hash_pairs"):
        if launches_tower[name] <= 0:
            raise SystemExit(f"full chain launched {name} no time")
    msm_runs = {k: native.MSM_CALLS[k] - msm_before[k] for k in msm_before}
    if min(msm_runs.values()) <= 0:
        raise SystemExit(f"full chain: a native MSM did not run: {msm_runs}")
    res = chain.block
    src, rigs = res.source, res.recursion_rigs
    # every base, leaf and node task of the chain's DAG holds a real record,
    # each leaf's tail is its queue segment's, the last its type's queue's
    last_tail = {}
    for task in tower_dag(res):
        if task.kind == "scheduler":
            continue
        rec = sch.stored_record(src, task)
        if not rec or not rec.get("real"):
            raise SystemExit(f"tower: no real record of task {task.key()}")
        if task.kind == "leaf":
            tail = [int(v) for v in rec["proof"].public_inputs[-12:]]
            if tail != [int(v) % P for v in task.payload.queue_tail]:
                raise SystemExit(f"tower: the tail of leaf {task.key()} is "
                                 "not its queue segment's")
            last_tail[task.payload.base_circuit_type] = tail
    for t in spot:
        if last_tail.get(t) != [int(v) % P for v in
                                res.artifacts.recursion_queues[t].tail]:
            raise SystemExit(f"tower: the last leaf's tail of type {t} is "
                             "not its recursion-queue tail")
    srec = src.get_scheduler_proof()
    if not srec or not srec.get("real") or srec["types"] != sorted(spot) \
            or srec["num_blob_slots"] != 1:
        raise SystemExit("tower: no real scheduler proof with the types' "
                         "slots and one blob slot")
    sb, slay, sbuilt, ssetup, sW = rigs[("scheduler_witness",)]
    # the scheduler proved again from the same witness: the same bytes
    again_t = time.time()
    again = pk.prove(sbuilt.ir, ssetup, sW, bcfg, device=dev)
    torch.cuda.synchronize()
    sched_warm_s = time.time() - again_t
    if serde.proof_to_json(again) != serde.proof_to_json(srec["proof"]):
        raise SystemExit("tower: a second scheduler prove gave a different "
                         "proof")
    del again, sW
    # a tampered leaf proof under the node of type 7 leaves gates
    # unsatisfied (its node circuit made again here: the subtrees' circuits
    # stayed in their processes)
    nb, nlay = nc.synthesize_node(rigs[("leaf_final", 7)][0], bcfg, 1)
    lrec = src.get_leaf_layer_proof(int(leaf_for(7)), 0)
    honest = nb.unsatisfied_gates(nb.eval_values(nc.node_assignments(
        nlay, lrec["vk"], [lrec["proof"]]), dev), device=dev)
    bad_leaf = copy.deepcopy(lrec["proof"])
    bad_leaf.public_inputs[0] = (int(bad_leaf.public_inputs[0]) + 1) % P
    broken = nb.unsatisfied_gates(nb.eval_values(nc.node_assignments(
        nlay, lrec["vk"], [bad_leaf]), dev), device=dev)
    # a tampered scheduler public input is refused at verify
    bad_sched = copy.deepcopy(srec["proof"])
    bad_sched.public_inputs[0] = (int(bad_sched.public_inputs[0]) + 1) % P
    # the block commitment binds the blob's output hash: recomputed with
    # another output hash in the aux values, it differs
    sched_pi = [int(v) for v in chain.scheduler_pi]
    aux = sc_circ.scheduler_aux_values(res.scheduler_witness)
    out_hash = chain.eip4844[0]["output_hash"]
    words = [int.from_bytes(out_hash[i:i + 4], "big")
             for i in range(0, 32, 4)]
    if aux[-8:] != words:
        raise SystemExit("tower: the blob's output hash is not the last of "
                         "the scheduler's aux values")
    types = sorted(spot)
    node_recs = [src.get_node_layer_proof(t, 0, 0) for t in types]
    commit_args = ([r["vk"] for r in node_recs],
                   [r["proof"] for r in node_recs], 1)
    blob_args = dict(blob_vks=[chain.eip4844[0]["vk"]],
                     blob_proofs=[chain.eip4844[0]["proof"]], device=dev)
    other = aux[:-8] + [(w + 1) % P for w in words]
    commitment = {
        "recomputed_equal": sc_circ.scheduler_multi_public_inputs(
            slay, *commit_args, aux, **blob_args) == sched_pi,
        "other_output_hash_differs": sc_circ.scheduler_multi_public_inputs(
            slay, *commit_args, other, **blob_args) != sched_pi}
    if not all(commitment.values()):
        raise SystemExit(f"tower: the block commitment does not bind the "
                         f"blob's output hash: {commitment}")
    # compression mode 1 for the wrapper over the scheduler: Fr caps,
    # verified, bound to the scheduler's VK and public inputs; with one of
    # the scheduler's public inputs changed (past the VK prefix) the STARK
    # verifier refuses it. The "binding" SNARK verifies against its Fr VK
    # and the scheduler's public inputs.
    final = chain.final["final_proof"]
    fw_vk = [int(v) for v in chain.final["final_vk"]]
    sched_vk = [int(v) for v in chain.scheduler.vk]
    fw = ly.create_compression_for_wrapper_setup_data(
        1, chain.scheduler.ir, chain.scheduler.cfg, device=dev)
    snark_proof, snark_vk = chain.snark["proof"], chain.snark["vk"]
    fr_ok = all(0 <= v < sw.R for v in fw_vk) and all(
        0 <= int(v) < sw.R for cap in (final.witness_cap, final.stage2_cap,
                                       final.quotient_cap) for v in cap)
    wrap = {
        "for_wrapper_caps_are_fr": fr_ok and len(fw_vk) == 16,
        "for_wrapper_verifies": ly.verify_compression_for_wrapper_proof(
            1, chain.scheduler.ir, chain.scheduler.cfg, final, fw_vk,
            expected_inner_vk=sched_vk, device=dev),
        "for_wrapper_pis_are_scheduler_vk_and_pis":
            [int(v) for v in final.public_inputs] ==
            sched_vk + [int(v) for v in srec["proof"].public_inputs],
        "for_wrapper_tampered_rejected": not pk.verify(
            fw.sd.ir, fw_vk, pi_bumped(final, len(sched_vk)), fw.sd.config,
            device=dev, backend=fw.backend),
        "binding_public_input_packs_scheduler_pi":
            int(snark_proof.public_inputs[len(fw_vk) + 4]) ==
            cmp.compress_stark_pi_to_snark_pi(sched_pi) ==
            int(chain.final["snark_public_input"]),
        "binding_verifies": sw.verify_binding_proof(
            snark_vk, snark_proof, expected_fw_vk=fw_vk,
            expected_scheduler_pi=sched_pi),
        "binding_other_fw_vk_rejected": not sw.verify_binding_proof(
            snark_vk, snark_proof,
            expected_fw_vk=[fw_vk[0] + 1] + fw_vk[1:],
            expected_scheduler_pi=sched_pi),
        "binding_other_pi_rejected": not sw.verify_binding_proof(
            snark_vk, snark_proof, expected_fw_vk=fw_vk,
            expected_scheduler_pi=[(v + 1) % P for v in sched_pi])}
    # the for-wrapper proof and its VK, for the JAX package's verifier
    # (tests/test_torch_for_wrapper.py, `slow`), beside the --out file
    if args.out:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                               "fw_production")
        os.makedirs(out_dir, exist_ok=True)
        summary = dict(
            scheduler_vk=sched_vk, scheduler_pi=sched_pi,
            scheduler_config=dataclasses.asdict(bcfg),
            blob_config=dataclasses.asdict(blob_cfg),
            block=golden.WHOLE_BLOCK, spot_types=list(spot), kzg_domain=16,
            blob=blob.hex(), scheduler_shape=[chain.scheduler.ir.log_n,
                                              chain.scheduler.ir.num_witness],
            aux_values=[int(v) for v in sc_circ.scheduler_aux_values(
                res.scheduler_witness)])
        for name, obj in (("fw_production_vk.json", fw_vk),
                          ("fw_production_proof.json",
                           serde.proof_to_json(final)),
                          ("fw_production_summary.json", summary)):
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(obj, f)
        # the first production leaf of types 10 and 4, for the JAX
        # package's verifier over the IR of its builder shape
        # (tests/test_torch_tower13.py, `slow`)
        leaf_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                "leaf_production")
        os.makedirs(leaf_dir, exist_ok=True)
        for t in LEAF_PRODUCTION_TYPES:
            lrec = src.get_leaf_layer_proof(int(leaf_for(t)), 0)
            lir = rigs[("leaf_final", t)][0]
            summary = dict(
                type=t, index=0, arity=lrec["arity"],
                num_real=lrec["num_real"], block=golden.WHOLE_BLOCK,
                leaf_arity=golden.TOWER_LEAF_ARITY,
                config=dataclasses.asdict(bcfg), shape=builder_shape(lir),
                public_inputs=[int(v) for v in lrec["proof"].public_inputs])
            for name, obj in (("vk", [int(v) for v in lrec["vk"]]),
                              ("proof", serde.proof_to_json(lrec["proof"])),
                              ("summary", summary)):
                with open(os.path.join(
                        leaf_dir, f"leaf{t}_production_{name}.json"),
                        "w") as f:
                    json.dump(obj, f)
    del fw
    # the second wrap from the same scheduler proof: compression mode 1 at
    # LDE 32 and the "pi" SNARK, as full_chain proves them without
    # for_wrapper
    t_wrap = time.time()
    ck.reset_launches()
    verifier = ly.CompressionChain(chain.scheduler.ir, chain.scheduler.cfg,
                                   chain.scheduler.vk, device=dev)
    out1 = cmp.wrap_proof(srec["proof"], sched_pi, cmp.WrapperConfig(1),
                          verifier.prove_fn, verifier.verify_fn)
    final1 = out1["final_proof"]
    mode1 = ly.create_compression_layer_setup_data(
        1, chain.scheduler.ir, chain.scheduler.cfg, device=dev).sd
    watch = tracing.Stopwatch(dev)
    wsetup = sw.wrapper_setup()
    watch.lap("setup")
    pi_proof = sw.wrap_scheduler_pi(wsetup, sched_pi)
    watch.lap("prove")
    pi_ok = sw.verify_wrapped_proof(wsetup.vk, pi_proof,
                                    expected_scheduler_pi=sched_pi)
    watch.lap("verify")
    pi_snark_stats = watch.done(gates=wsetup.circuit.num_gates,
                                n=wsetup.vk.n, mode="pi")
    launches_pi_wrap = dict(ck.LAUNCHES)
    pi_wrap_s = time.time() - t_wrap
    wrap.update({
        "compression_verifies": verifier.verify_fn(1, final1,
                                                   out1["final_vk"]),
        "compression_pis_are_scheduler_vk_and_pis":
            [int(v) for v in final1.public_inputs] ==
            sched_vk + [int(v) for v in srec["proof"].public_inputs],
        "compression_tampered_rejected": not pk.verify(
            mode1.ir, mode1.vk, pi_bumped(final1, len(sched_vk)),
            mode1.config, device=dev),
        "snark_public_input_packs_scheduler_pi":
            int(pi_proof.public_inputs[-1]) ==
            cmp.compress_stark_pi_to_snark_pi(sched_pi) ==
            int(out1["snark_public_input"]),
        "snark_verifies": pi_ok,
        "snark_other_pi_rejected": not sw.verify_wrapped_proof(
            wsetup.vk, pi_proof,
            expected_scheduler_pi=[(v + 1) % P for v in sched_pi])})
    # the tower's keccak base proof (type 5, verified in its worker) with a
    # public input or an OOD value changed is refused by its base verifier
    insts5, ch5, cap5 = oracle.block_payloads(res.artifacts, geo)[5]
    base5 = src.get_base_layer_proof(5, 0)["proof"]
    with ly.engine_override(bcfg):
        base5_ok = [ly.verify_base_instance(5, insts5[0], ch5, cap5, pr,
                                            device=dev)
                    for pr in (pi_bumped(base5), ood_bumped(base5))]
    tamper = {"leaf_under_node": len(honest) == 0 and len(broken) > 0,
              "scheduler_public_input": not pk.verify(
                  sbuilt.ir, ssetup.vk(), bad_sched, bcfg, device=dev),
              "keccak_base": base5_ok == [False, False]}
    if not all(tamper.values()) or not all(wrap.values()):
        raise SystemExit(f"tower: a check of the chain failed: {tamper} "
                         f"{wrap}")
    # the tower's tasks one by one: phase `tower13`
    tasks = {task_name(k): rounded(v) for k, v in res.tower_stats.items()
             if k[0] == "scheduler"}
    wrap_stats = {k: rounded(v) for k, v in chain.stats.items()}
    wrap_stats["pi_compression_1"] = rounded(verifier.stats[1])
    wrap_stats["pi_snark"] = rounded(pi_snark_stats)
    mode1_shape = (verifier.stats[1]["width"], verifier.stats[1]["log_n"])
    phase("tower", block=golden.WHOLE_BLOCK, spot_types=list(spot),
          config=golden.TOWER_CONFIG,
          blob_config=chain.stats["eip4844_0"]["config"],
          compression_config=dataclasses.asdict(
              ly.compression_engine_config(1)),
          for_wrapper_config=dataclasses.asdict(
              ly.for_wrapper_engine_config(1)),
          snark_modes=["binding (in the chain)", "pi (second wrap)"],
          blob_bytes=len(blob), kzg_domain=16,
          cycles=res.cycles,
          instances={t: len(m.instances)
                     for t, m in res.circuit_makers.items()},
          timings={k: round(v, 3) for k, v in res.timings.items()},
          chain_s=round(chain_s, 3), tasks=tasks, wrap_tasks=wrap_stats,
          scheduler_prove_warm_s=round(sched_warm_s, 3),
          scheduler_second_proof_equal=True,
          pi_wrap_s=round(pi_wrap_s, 3), pi_wrap_launches=launches_pi_wrap,
          scheduler_pi=sched_pi, snark_public_input=str(
              chain.final["snark_public_input"]),
          leaf_tails_equal_queue_tails=True,
          unsatisfied_gates_tampered_leaf=len(broken),
          commitment_binds_blob=commitment, wrap_checks=wrap,
          tampered_rejected=tamper, native_msm_runs=msm_runs,
          launches=launches_tower)
    leaf_shapes = tower13_phase(dev, phase, res, sum(res.timings.values()))
    launches_pi_wrap = dict(launches_pi_wrap)
    del res, src, rigs, sb, slay, sbuilt, ssetup, nb, nlay, chain, verifier
    del final, final1, mode1
    ly._SETUP_CACHE.clear()
    torch.cuda.empty_cache()
    if args.profile:
        # the chain once more under the profiler (the device's activity
        # alone); its busy time against the unprofiled run's wall time
        _wall_s, rows = device_rows(run_chain, host_too=False)
        busy_s = sum(r[2] for r in rows) / 1e6
        top = sorted(rows, key=lambda r: -r[2])[:12]
        phase("profile_chain", chain_s=round(chain_s, 3),
              profiled_wall_s=round(_wall_s, 3),
              device_busy_s=round(busy_s, 3),
              device_idle_share=round(1 - busy_s / chain_s, 3),
              device_launches=sum(r[1] for r in rows),
              top_kernels=[{"name": k[:80], "count": c,
                            "device_ms": round(us / 1e3, 2)}
                           for k, c, us in top])
        ly._SETUP_CACHE.clear()
        torch.cuda.empty_cache()

    # -- eip4844: the blob circuit at full width ------------------------------
    launches_blob, blob_shape = eip4844_phase(dev, phase, bcfg, rounded)

    # -- kernels_tower: K1 and K2 at the tower's shapes ----------------------
    # a leaf's 48 columns on the 2^20-point commitment domain for the
    # multiply; the 2^20 leaves of that commitment for the permutation
    timing_tower = {}
    shape = (48, 1 << 20)
    ta, tb = rand_field(shape), rand_field(shape)
    errs["gl_mul"] = max(errs["gl_mul"], check_equal(
        "gl_mul tower shape", ck.gl_mul(ta, tb), ck.gl_mul_plain(ta, tb)))
    timing_tower["gl_mul_leaf"] = {
        "shape": list(shape),
        "ms": cuda_ms(lambda: ck.gl_mul(ta, tb), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.gl_mul_plain(ta, tb), 1, 3),
        "bytes": 3 * 8 * ta.numel(), "ops": ta.numel() * OPS_MUL}
    del ta, tb
    states = 1 << 20
    ts = rand_field((states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 tower shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing_tower["poseidon2_permute"] = {
        "shape": [states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * states,
        "ops": states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    for t in timing_tower.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_tower", tolerance=0,
          max_abs_err={k: errs[k] for k in ("gl_mul", "poseidon2_permute")},
          timing={k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                      for kk, vv in t.items()}
                  for k, t in timing_tower.items()})
    timing_t13 = kernels_tower13_phase(dev, phase, leaf_shapes, check_equal,
                                       cuda_ms, errs)

    # -- kernels_wrap: K1 and K2 at mode 1's LDE and the blob circuit's -------
    # mode 1's columns on its LDE-32 domain for the multiply and its leaves
    # for the permutation; the blob circuit's columns on its rate-2 domain
    width, log_n = mode1_shape
    lde = ly.compression_engine_config(1).rate
    shapes = {"gl_mul_mode1": (width, lde << log_n),
              "gl_mul_blob": (blob_shape[0], 2 << blob_shape[1])}
    timing_wrap = {}
    for key, shape in shapes.items():
        ta, tb = rand_field_on(dev, shape), rand_field_on(dev, shape)
        errs["gl_mul"] = max(errs["gl_mul"], check_equal(
            key, ck.gl_mul(ta, tb), ck.gl_mul_plain(ta, tb)))
        timing_wrap[key] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: ck.gl_mul(ta, tb), 2, 10),
            "plain_ms": cuda_ms(lambda: ck.gl_mul_plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * ta.numel(), "ops": ta.numel() * OPS_MUL}
        del ta, tb
        torch.cuda.empty_cache()
    states = lde << log_n
    ts = rand_field_on(dev, (states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 mode-1 shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing_wrap["poseidon2_permute_mode1"] = {
        "shape": [states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * states,
        "ops": states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    torch.cuda.empty_cache()
    for t in timing_wrap.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_wrap", tolerance=0,
          max_abs_err={k: errs[k] for k in ("gl_mul", "poseidon2_permute")},
          timing={k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                      for kk, vv in t.items()}
                  for k, t in timing_wrap.items()})

    timing_fw = kernels_fw_phase(dev, phase, rand_field, check_equal,
                                 cuda_ms, errs, mode1_shape)
    paths = {"full_chain": launches_tower, "pi_wrap": launches_pi_wrap,
             "eip4844": launches_blob}
    return paths, timing_tower, timing_wrap, timing_fw, timing_t13


# The base types of phase `tower13`: all 13 of the whole block, at the
# JAX package's `leaf_arity` `golden.TOWER_LEAF_ARITY` (type 10's 18 paths
# in 9 leaves, type 3's 4 instances in 2).
TOWER13_TYPES = tuple(range(1, 14))
# processes proving the types' base, leaf and node tasks side by side
# (`harness.run_block(type_workers=...)`): the host's synthesis, the larger
# part of a leaf's time, runs three at a time on the machine's cores
TOWER13_WORKERS = 3
# the hash circuit phase `hashes` proves itself; phase `tower13` proves
# the others (2, 3, 5, 13) at that geometry
HASHES_PROVED = (6,)
# the base type phase `block` proves itself: the first storage query's
# read path, proved twice and tampered, its root the initial one
BLOCK_PROVED = (10,)
# the types whose first production leaf `--out` writes into
# leaf_production/ (test_artifacts/leaf{10,4}_production_*)
LEAF_PRODUCTION_TYPES = (10, 4)


@contextlib.contextmanager
def _worker_allocator():
    """The allocator setting of the `type_workers` processes: freed
    segments go back to the card (the leaves' proves take turns with the
    other processes' held memory on the one card). Set for the spawned
    processes only; this one's allocator is already running."""
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def builder_shape(ir):
    """The `CircuitBuilder.ir_shape()` of a recursion circuit's IR: its
    PLONK slots and Poseidon2 tiles are its two gate parts' counts."""
    slots, *rest = ir.gate_part_counts
    return dict(slots=slots, tiles=rest[0] // 12 if rest else 0,
                log_n=ir.log_n, num_witness=ir.num_witness,
                num_const=ir.num_const,
                public_input_cells=[list(c) for c in ir.public_input_cells],
                copy_chunk=ir.copy_chunk)


def tower_dag(res):
    """The proof DAG of a `harness.run_block` result at the tower's leaf
    arity."""
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.prover import scheduler as sch
    return sch.build_block_dag(
        {t: m.queue for t, m in res.circuit_makers.items()},
        {t: a.num_instances for t, a in res.artifacts.per_circuit.items()},
        leaf_arity=golden.TOWER_LEAF_ARITY)


def rand_field_on(dev, shape):
    """Canonical Goldilocks values drawn on the card (the host's generator
    takes seconds at the wide kernel phases' sizes): u64 bit patterns, the
    rare one at or above p less p."""
    import torch
    x = torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64,
                      device=dev)
    high = (x < 0) & (x >= -((1 << 32) - 1))
    return torch.where(high, x + ((1 << 32) - 1), x)


def _golden_json(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def tower13_golden_phase(dev, phase):
    """Phase `tower13_golden`: the JAX package's golden tower of the small
    whole block over `golden.TOWER13_GOLDEN_TYPES`, and storage
    application's golden tower (`golden.TYPE10_GOLDEN`: two depth-4 paths
    in one leaf of arity 2), made on the card by
    `harness.run_block(tower=True)`: every base, leaf, node and scheduler
    VK and proof, and the schedulers' public inputs, equal its bytes."""
    import torch

    from zkevm_harness_tpu_torch import golden, harness
    from zkevm_harness_tpu_torch.circuits.types import (leaf_for,
                                                        testing_geometry)
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde
    from zkevm_harness_tpu_torch.vm import isa

    golden_json = _golden_json

    def as_json(proof):
        return json.loads(json.dumps(serde.proof_to_json(proof)))

    # -- tower13_golden: the JAX package's tower of the small whole block ----
    t0 = time.time()
    gcfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    gtypes = tuple(golden.TOWER13_GOLDEN_TYPES)
    contracts = dict(golden.hash_callees(
        isa, golden.WHOLE_GOLDEN["callee_reps"]))
    # the golden circuits are small (testing geometry, 2 queries): proved
    # in this process, without ten processes to start and switch between
    # on the card
    with ly.engine_override(gcfg):
        gres = harness.run_block(
            golden.whole_block(isa, **golden.WHOLE_GOLDEN),
            prove_mode="spot", spot_types=gtypes, contracts=contracts,
            tower=True, recursion_cfg=gcfg, device=dev)
    gsrc = gres.source
    want = golden_json("tower13_summary.json")
    compared = 0
    for t in gtypes:
        leaf = gsrc.get_leaf_layer_proof(int(leaf_for(t)), 0)
        node = gsrc.get_node_layer_proof(t, 0, 0)
        bases = [gsrc.get_base_layer_proof(t, i)["proof"]
                 for i in range(want["leaves"][str(t)]["num_real"])]
        if [as_json(p) for p in bases] != \
                golden_json(f"tower13_base_{t}_proofs.json"):
            raise SystemExit(f"tower13_golden: the base proofs of type {t} "
                             "differ from the golden JSON")
        for kind, rec in (("leaf", leaf), ("node", node)):
            if not rec or not rec.get("real") or \
                    [int(v) for v in rec["vk"]] != golden_json(
                        f"tower13_{kind}_{t}_vk.json") or \
                    as_json(rec["proof"]) != golden_json(
                        f"tower13_{kind}_{t}_proof.json"):
                raise SystemExit(f"tower13_golden: the {kind} VK or proof of "
                                 f"type {t} differs from the golden JSON")
        compared += 2 + len(bases)
    srec = gsrc.get_scheduler_proof()
    if [int(v) for v in srec["vk"]] != golden_json(
            "tower13_scheduler_vk.json") or as_json(srec["proof"]) != \
            golden_json("tower13_scheduler_proof.json") or \
            [int(v) for v in srec["scheduler_pi"]] != want["scheduler_pi"]:
        raise SystemExit("tower13_golden: the scheduler's VK, proof or "
                         "public inputs differ from the golden JSON")
    whole_s = time.time() - t0
    del gres, gsrc, srec
    ly._SETUP_CACHE.clear()
    torch.cuda.empty_cache()
    # storage application's golden tower at the JAX package's leaf_arity
    t1 = time.time()
    geo = dataclasses.replace(testing_geometry(),
                              storage_tree_depth=golden.TYPE10_GOLDEN["depth"])
    with ly.engine_override(gcfg):
        tres = harness.run_block(
            golden.type10_block(isa), geometry=geo, prove_mode="spot",
            spot_types=(10,), tower=True, recursion_cfg=gcfg,
            leaf_arity=golden.TYPE10_GOLDEN["leaf_arity"], device=dev)
    tsrc = tres.source
    want10 = golden_json("tower10_summary.json")
    bases = [tsrc.get_base_layer_proof(10, i)["proof"]
             for i in range(want10["leaf"]["num_real"])]
    if [as_json(p) for p in bases] != golden_json("tower10_base_proofs.json"):
        raise SystemExit("tower13_golden: the type-10 path proofs differ "
                         "from the golden JSON")
    for kind, rec in (("leaf", tsrc.get_leaf_layer_proof(int(leaf_for(10)),
                                                         0)),
                      ("node", tsrc.get_node_layer_proof(10, 0, 0)),
                      ("scheduler", tsrc.get_scheduler_proof())):
        if not rec or not rec.get("real") or \
                [int(v) for v in rec["vk"]] != golden_json(
                    f"tower10_{kind}_vk.json") or \
                as_json(rec["proof"]) != golden_json(
                    f"tower10_{kind}_proof.json"):
            raise SystemExit(f"tower13_golden: the type-10 {kind} VK or "
                             "proof differs from the golden JSON")
    if [int(v) for v in tsrc.get_scheduler_proof()["scheduler_pi"]] != \
            want10["scheduler_pi"]:
        raise SystemExit("tower13_golden: the type-10 tower's scheduler "
                         "public inputs differ from the golden JSON")
    phase("tower13_golden", config=golden.TOWER_GOLDEN_CONFIG,
          block=golden.WHOLE_GOLDEN, spot_types=list(gtypes),
          proofs_equal=compared + 1, vk_equal=True, proof_equal=True,
          scheduler_pi_equal=True, verify=True, total_s=round(whole_s, 3),
          type10={"golden": golden.TYPE10_GOLDEN,
                  "proofs_equal": len(bases) + 3,
                  "leaf_arity": want10["leaf"]["arity"],
                  "total_s": round(time.time() - t1, 3)})
    del tres, tsrc
    ly._SETUP_CACHE.clear()
    torch.cuda.empty_cache()


# The golden phases that run in processes of their own beside the CLI and
# mesh phases (they time nothing; what they check is bytes): name -> the
# function of (device, phase) that runs them
BACKGROUND_GOLDENS = {"golden_tower": golden_tower_phases,
                      "tower13_golden": tower13_golden_phase}


def _background_golden(name):
    """A spawned process's run of `BACKGROUND_GOLDENS[name]` on the card:
    (its phase records, what the function returned, the message it stopped
    with or None)."""
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    recs = []

    def phase(pname, **fields):
        recs.append({"phase": pname, "process_s": round(time.time() - t0, 1),
                     **fields})

    try:
        out = BACKGROUND_GOLDENS[name](dev, phase)
    except SystemExit as e:
        return recs, None, str(e)
    return recs, out, None


def tower13_phase(dev, phase, res, wall_s):
    """Phase `tower13`: the whole block's tower at production parameters
    over `TOWER13_TYPES` at `golden.TOWER_LEAF_ARITY`, as the full chain of
    phase `tower` proved it (`res`, its `harness.run_block` result): every
    instance's base proof, each type's leaves over its instances a chunk at
    a time and a node over them, the scheduler over the types' slots (and
    the blob's), each verified with its expected public inputs in the run;
    here each type's leaves cover all its instances and its node all its
    leaves, the base VK under each leaf equals the committed production
    VK, type 10's path proofs chain the storage roots from the artifacts'
    initial root to their final one, and a tampered scheduler public input
    is refused. Prints per task its shape, the seconds of synthesis,
    finalize, fill, setup, prove, verify and of waiting for the card, its
    peak memory, its K1 and K2 launches and its process's peak host RSS;
    per leaf the running peak at the end of each prover stage; the largest
    leaf apart, each worker's peak RSS, and the sums over the tower.
    Returns the leaves' (columns, log rows)."""
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import \
        storage_application_circuit as sappcirc
    from zkevm_harness_tpu_torch.circuits.types import (GeometryConfig,
                                                        leaf_for)
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import plonkish as pk

    P = gl.P
    bcfg = pk.PlonkishConfig(**golden.TOWER_CONFIG)

    def task_name(key):
        kind, ctype, _depth, index = key
        if kind == "leaf":
            ctype -= 2  # the base type the leaf aggregates
        if kind == "scheduler":
            return kind
        return f"{kind}_{ctype}" + (f"_{index}" if kind == "base" or index
                                    else "")

    src, rigs = res.source, res.recursion_rigs
    instances = {t: len(m.instances) for t, m in res.circuit_makers.items()}
    leaves = {}
    for task in tower_dag(res):
        if task.kind == "leaf":
            leaves.setdefault(task.payload.base_circuit_type, []).append(task)
    vks, shapes = {}, {}
    for t in TOWER13_TYPES:
        for i in range(instances[t]):
            rec = src.get_base_layer_proof(t, i)
            if not rec or not rec.get("real"):
                raise SystemExit(f"tower13: no real base proof {i} of type "
                                 f"{t}")
        recs = [src.get_leaf_layer_proof(int(leaf_for(t)), task.index)
                for task in leaves[t]]
        node = src.get_node_layer_proof(t, 0, 0)
        if not all(r and r.get("real") for r in recs) or \
                sum(r["num_real"] for r in recs) != instances[t] or \
                not node or not node.get("real") or \
                node["arity"] != len(recs):
            raise SystemExit(f"tower13: the leaves of type {t} do not cover "
                             "its instances, or its node not its leaves")
        # each leaf's public inputs open with the base VK it verified
        # in-circuit: the committed production VK of the type
        path = os.path.join(PROD_VK_DIR, f"vk_{t}.json")
        if not os.path.exists(path):
            path = os.path.join(GOLDEN_DIR, f"vk_{t}_production.json")
        want = _golden_json(path)
        for r in recs:
            if [int(v) for v in r["proof"].public_inputs[:-16]] != want:
                raise SystemExit(f"tower13: the base VK under a leaf of type "
                                 f"{t} differs from {path}")
        vks[t] = os.path.relpath(path, REPO_DIR)
        shapes[t] = {"instances": instances[t], "leaves": len(recs),
                     "leaf_arity": recs[0]["arity"],
                     "node_arity": node["arity"]}
    # type 10: query k's read path opens root k, its write path gives root
    # k + 1; the first is the artifacts' initial root, the last their final
    sa = res.artifacts.storage_application
    g10 = sappcirc.PathGeometry(depth=GeometryConfig().storage_tree_depth)
    roots = [sappcirc.root_bytes(g10, src.get_base_layer_proof(10, i)[
        "proof"].public_inputs) for i in range(instances[10])]
    if roots[0::2] != [sa.initial_root] + roots[1::2][:-1] or \
            roots[-1] != sa.final_root:
        raise SystemExit("tower13: the storage paths' roots do not chain "
                         "from the initial to the final root")
    srec = src.get_scheduler_proof()
    if not srec or not srec.get("real") or \
            srec["types"] != sorted(TOWER13_TYPES):
        raise SystemExit("tower13: no real scheduler proof over the types' "
                         "slots")
    sir, svk = rigs[("scheduler",)]
    bad = copy.deepcopy(srec["proof"])
    bad.public_inputs[0] = (int(bad.public_inputs[0]) + 1) % P
    if pk.verify(sir, svk, bad, bcfg, device=dev):
        raise SystemExit("tower13: a tampered scheduler public input was "
                         "accepted")
    keys = ("log_n", "width", "gates", "arity", "synthesis_s", "finalize_s",
            "fill_s", "setup_s", "prove_s", "verify_s", "device_wait_s",
            "max_memory_allocated", "host_max_rss", "pid", "stage_peaks")
    tasks, launches, workers = {}, {}, {}
    for key, st in res.tower_stats.items():
        row = {k: (round(st[k], 3) if isinstance(st[k], float) else st[k])
               for k in keys if k in st}
        row["launches"] = {k: st["launches"][k]
                           for k in ("gl_mul", "poseidon2_permute")}
        tasks[task_name(key)] = row
        for k, v in st["launches"].items():
            launches[k] = launches.get(k, 0) + v
        w = workers.setdefault(st["pid"], {"types": [], "host_max_rss": 0})
        t = key[1] - 2 if key[0] == "leaf" else key[1]
        if key[0] != "scheduler" and t not in w["types"]:
            w["types"].append(t)
        w["host_max_rss"] = max(w["host_max_rss"], st["host_max_rss"])
    for name in ("gl_mul", "poseidon2_permute"):
        if launches[name] <= 0:
            raise SystemExit(f"tower13 launched {name} no time")
    leaf_rows = {k: v for k, v in tasks.items() if k.startswith("leaf_")}
    top = max(leaf_rows, key=lambda k: (leaf_rows[k]["log_n"],
                                        leaf_rows[k]["width"]))
    phase("tower13", nvidia_smi=nvidia_smi_line(), block=golden.WHOLE_BLOCK,
          config=golden.TOWER_CONFIG, spot_types=list(TOWER13_TYPES),
          leaf_arity=golden.TOWER_LEAF_ARITY,
          type_workers=TOWER13_WORKERS,
          # host memory: this process's peak, each process's at the end of
          # its last task (the scheduler's process is this one)
          host_max_rss={"script": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss * 1024},
          workers={str(pid): w for pid, w in workers.items()},
          per_type=shapes, instances=instances, cycles=res.cycles,
          timings={k: round(v, 3) for k, v in res.timings.items()},
          wall_s=round(wall_s, 3), tasks=tasks,
          largest_leaf={"task": top, **leaf_rows[top]},
          peak_2e22_leaves={k: v["max_memory_allocated"]
                            for k, v in leaf_rows.items()
                            if v["log_n"] == 22},
          scheduler_pi=[int(v) for v in srec["scheduler_pi"]],
          base_vk_equal=vks, leaf_tails_equal_queue_tails=True,
          storage_roots_chained=True, scheduler_tampered_rejected=True,
          launches=launches)
    return sorted({(st["width"], st["log_n"])
                   for k, st in res.tower_stats.items()
                   if k[0] == "leaf"} - {(48, 19)})


def kernels_tower13_phase(dev, phase, leaf_shapes, check_equal, cuda_ms,
                          errs):
    """Phase `kernels_tower13`: K1 and K2 against their plain versions and
    timed at the new leaves' shapes: each leaf shape's columns over its
    rows (a coset of its quotient) and the largest leaf's columns over its
    rate-2 commitment domain (its LDE) for the multiply, and that leaf's
    commitment leaves for the permutation. Returns the timings."""
    import torch

    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl

    def rand_field(shape):
        return rand_field_on(dev, shape)

    timing = {}
    width, log_n = max(leaf_shapes, key=lambda wl: (wl[1], wl[0]))
    lde = (width, log_n + 1)
    for width, log_n in leaf_shapes + [lde]:
        shape = (width, 1 << log_n)
        ta, tb = rand_field(shape), rand_field(shape)
        # the plain version's dozen temporaries of the operands' size do
        # not fit the card beside a 2^24-point LDE's operands: it runs on
        # four blocks of columns there, checked and timed block by block
        step = -(-width // 4) if (width, log_n) == lde else width
        got = ck.gl_mul(ta, tb)
        for j in range(0, width, step):
            errs["gl_mul"] = max(errs["gl_mul"], check_equal(
                f"gl_mul leaf {shape}", got[j:j + step],
                ck.gl_mul_plain(ta[j:j + step], tb[j:j + step])))
        del got
        label = "lde_" if (width, log_n) == lde else ""
        timing[f"gl_mul_leaf_{label}{width}x2^{log_n}"] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: ck.gl_mul(ta, tb), 2, 10),
            "plain_ms": sum(cuda_ms(lambda: ck.gl_mul_plain(
                ta[j:j + step], tb[j:j + step]), 1, 3)
                for j in range(0, width, step)),
            "plain_column_blocks": -(-width // step),
            "bytes": 3 * 8 * ta.numel(), "ops": ta.numel() * OPS_MUL}
        del ta, tb
        torch.cuda.empty_cache()
    states = 1 << lde[1]
    ts = rand_field((states, 12))
    # the plain version takes seconds a call at 2^24 states: the call the
    # kernel is held against is the one timed
    plain = {}
    plain_ms = cuda_ms(lambda: plain.setdefault(
        "out", ck.poseidon2_permute_plain(ts)), 0, 1)
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 leaf shape", ck.poseidon2_permute(ts), plain.pop("out")))
    timing["poseidon2_permute_leaf"] = {
        "shape": [states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": plain_ms,
        "bytes": 2 * 8 * 12 * states,
        "ops": states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    torch.cuda.empty_cache()
    for t in timing.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_tower13", nvidia_smi=nvidia_smi_line(), tolerance=0,
          max_abs_err={k: errs[k] for k in ("gl_mul", "poseidon2_permute")},
          timing={k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                      for kk, vv in t.items()}
                  for k, t in timing.items()})
    return timing


# K3's times in its first design (four 64-bit limbs, CIOS on a * b and
# __umul64hi with compare-and-select carries, full reduction after every
# operation, 80 registers), at the shapes `kernels_fw` times, as an earlier
# run of this script measured them on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6). They are stored figures, not measured by this run:
# `kernels_fw` prints them under a key that says so, and the `kernels` line
# never carries them.
K3_EARLIER_MS_NOT_MEASURED = {"bn254_hash_rows": 81.7897,
                              "bn254_hash_pairs": 2.8908}


def kernels_fw_phase(dev, phase, rand_field, check_equal, cuda_ms, errs,
                     mode1_shape):
    """Phase `kernels_fw`: K3 (bn254_hash_rows, bn254_hash_pairs) against
    its plain version, then timed at the production for-wrapper tree's
    shapes beside its work bound. The plain version is exact Python ints
    (seconds at these shapes): the check runs at 1,024 rows of mode 1's
    width and 2,048 pairs, and at edge inputs: rows of Goldilocks p - 1
    (the largest packed Fr) at three widths, pairs of Fr p - 1 in every
    lane. The times: the tree's 2^(log_n + 1) leaves and the pairs of its
    first level, the whole tree's commitment (cap 16) in total and per
    level, and the verifier's level of 40 paths. Returns the timings."""
    import numpy as np
    import torch

    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import hash_backend as hb
    from zkevm_harness_tpu_torch.utils import poseidon2_bn254 as p2b

    rng = np.random.default_rng(254)
    fr = p2b.FR
    params = p2b.get_params_bn254()

    def fr_limbs(k, vals=None):
        if vals is None:
            words = rng.integers(0, 1 << 63, size=(k, 4), dtype=np.int64)
            vals = [sum(int(w) << (63 * j) for j, w in enumerate(ws)) % fr
                    for ws in words.tolist()]
            vals[:3] = [0, 1, fr - 1][:k]
        return torch.from_numpy(p2b.to_limbs(vals))

    def plain_once(fn, arg):
        """The plain version's digests and host milliseconds (one call)."""
        t = time.perf_counter()
        out = fn(arg)
        return out, (time.perf_counter() - t) * 1e3

    def same(name, fn, plain, arg):
        want, ms = plain_once(plain, arg.cpu())
        return check_equal(name, fn(arg.to(dev)), want.to(dev)), ms

    width, log_n = mode1_shape
    rows = rand_field((width, 1024))
    err_rows, ms_plain_rows = same("bn254_hash_rows mode-1 width",
                                   ck.bn254_hash_rows,
                                   ck.bn254_hash_rows_plain, rows)
    pairs = fr_limbs(2 * 2048)
    err_pairs, ms_plain_pairs = same("bn254_hash_pairs 2048",
                                     ck.bn254_hash_pairs,
                                     ck.bn254_hash_pairs_plain, pairs)
    top = gl.P - 1
    edges = {}
    for w in (width, 7, 1):
        edges[f"rows_p_minus_1_w{w}"] = same(
            f"bn254_hash_rows of p - 1, width {w}", ck.bn254_hash_rows,
            ck.bn254_hash_rows_plain,
            gl.from_u64(np.full((w, 64), top, dtype=np.uint64), dev))[0]
    edges["pairs_p_minus_1"] = same(
        "bn254_hash_pairs of p - 1", ck.bn254_hash_pairs,
        ck.bn254_hash_pairs_plain, fr_limbs(128, [fr - 1] * 128))[0]
    errs["bn254_hash_rows"] = max(err_rows, *(
        v for k, v in edges.items() if k.startswith("rows")))
    errs["bn254_hash_pairs"] = max(err_pairs, edges["pairs_p_minus_1"])

    n_fr = -(-width // 3)
    perms_per_row = (n_fr + 1) // 2
    check = {"bn254_hash_rows": ([width, 1024], rows, ms_plain_rows,
                                 1024 * perms_per_row),
             "bn254_hash_pairs": ([2 * 2048, 4], pairs.to(dev),
                                  ms_plain_pairs, 2048)}
    leaves = 2 << log_n  # rate 2
    # (shape, input, permutations, values into / out of Montgomery form,
    # bytes)
    prod = {"bn254_hash_rows": ([width, leaves], rand_field((width, leaves)),
                                leaves * perms_per_row, leaves * n_fr, leaves,
                                width * leaves * 8 + leaves * 32),
            "bn254_hash_pairs": ([leaves, 4], fr_limbs(leaves).to(dev),
                                 leaves // 2, leaves, leaves // 2,
                                 leaves * 32 + leaves * 16)}
    timing_fw = {}
    for name, fn in (("bn254_hash_rows", ck.bn254_hash_rows),
                     ("bn254_hash_pairs", ck.bn254_hash_pairs)):
        cshape, carg, cplain, cperms = check[name]
        pshape, parg, pperms, pin, pout, pbytes = prod[name]
        ops_ms = bn254_bound_ms(params, pperms, pin, pout)
        bytes_ms = pbytes / PEAK_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: fn(parg), 1, 5)
        bound = max(ops_ms, bytes_ms)
        timing_fw[name] = {
            "shape": pshape, "permutations": pperms, "ms": ms,
            "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound / ms,
            "plain_ms": cplain, "plain_shape": cshape,
            "check_ms": cuda_ms(lambda: fn(carg), 1, 5),
            "check_permutations": cperms}
        del parg
    del rows, pairs

    # the whole tree, as the prover commits it, and its levels one by one
    cols = rand_field((width, leaves))
    backend = hb.Bn254Backend(dev)
    tree = backend.commit_rows(cols, 16)
    commit_ms = cuda_ms(lambda: backend.commit_rows(cols, 16), 1, 3)
    levels = [{"nodes": leaves, "ms": timing_fw["bn254_hash_rows"]["ms"],
               "bound_ms": timing_fw["bn254_hash_rows"]["bound_ms"]}]
    for lvl in tree.levels[:-1]:
        m = lvl.shape[0] // 2
        levels.append({"nodes": m,
                       "ms": cuda_ms(lambda: ck.bn254_hash_pairs(lvl), 2, 5),
                       "bound_ms": bn254_bound_ms(params, m, 2 * m, m)})
    del cols, tree
    commit = {"shape": [width, leaves], "cap": 16, "ms": commit_ms,
              "bound_ms": sum(lv["bound_ms"] for lv in levels),
              "levels_ms_sum": sum(lv["ms"] for lv in levels),
              "levels": levels}
    # the verifier's level: one pair per opened path, 40 queries
    path = fr_limbs(80)
    err_path, _ = same("bn254_hash_pairs 40", ck.bn254_hash_pairs,
                       ck.bn254_hash_pairs_plain, path)
    errs["bn254_hash_pairs"] = max(errs["bn254_hash_pairs"], err_path)
    path = path.to(dev)
    verifier_level = {"pairs": 40,
                      "ms": cuda_ms(lambda: ck.bn254_hash_pairs(path), 10,
                                    200),
                      "bound_ms": bn254_bound_ms(params, 40, 80, 40)}
    torch.cuda.empty_cache()
    report = ck.ptxas_report(ck.BUILD_LOG.get("poseidon2_bn254", ""))
    ptxas = {k: v for name, v in report.items()
             for k in ("hash_rows_kernel", "hash_pairs_kernel") if k in name}

    def r4(d):
        return {k: (round(v, 4) if isinstance(v, float) else
                    r4(v) if isinstance(v, dict) else
                    [r4(x) for x in v] if isinstance(v, list) and v
                    and isinstance(v[0], dict) else v)
                for k, v in d.items()}

    phase("kernels_fw", tolerance=0,
          max_abs_err={k: errs[k] for k in ("bn254_hash_rows",
                                            "bn254_hash_pairs")},
          edge_inputs=edges,
          work_insns_per_permutation=bn254_permutation_insns(params),
          ptxas=ptxas, timing={k: r4(t) for k, t in timing_fw.items()},
          earlier_design_ms_not_measured=K3_EARLIER_MS_NOT_MEASURED,
          commit=r4(commit), verifier_level=r4(verifier_level))
    return timing_fw


def wrap_golden_phase(dev, phase, gres, gcfg, golden_json, rounded):
    """Phase `wrap_golden`: made on the card, equal to the JAX package's
    bytes (tools/gen_wrap_golden.py): the five-mode compression chain over
    the `queue_ir(5)` stand-in; mode 1 at its production config (LDE 32)
    over the golden tower's scheduler proof `gres` made; the "pi" SNARK
    proof of that scheduler's public inputs; the EIP-4844 witness chain and
    the blob circuit's VK and proof at the 16-element testing domain; the
    full chain over the golden tower's block with that blob in the
    scheduler's blob slot (scheduler VK and proof, mode 1, SNARK)."""
    import torch

    from zkevm_harness_tpu_torch import convert, golden
    from zkevm_harness_tpu_torch import full_chain as fc
    from zkevm_harness_tpu_torch.circuits import queue_circuit as qc
    from zkevm_harness_tpu_torch.prover import compression as cmp
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import kzg, native, serde
    from zkevm_harness_tpu_torch.utils import snark_wrapper as sw
    from zkevm_harness_tpu_torch.utils.data_source import InMemoryDataSource
    from zkevm_harness_tpu_torch.utils.native import keccak256
    from zkevm_harness_tpu_torch.vm import isa
    from zkevm_harness_tpu_torch.witness import eip4844 as w4844

    t0 = time.time()
    laps = {}

    def lap(name):
        torch.cuda.synchronize()
        laps[name + "_s"] = round(time.time() - t0 - sum(laps.values()), 3)

    def same(stem, vk, proof):
        if [int(v) for v in vk] != golden_json(f"{stem}_vk.json") or \
                json.loads(json.dumps(serde.proof_to_json(proof))) != \
                golden_json(f"{stem}_proof.json"):
            raise SystemExit(f"wrap_golden: {stem} differs from the golden "
                             "JSON")

    def refused_past_vk(chain, mode, proof):
        """The mode's STARK verifier refuses `proof` with one of the inner
        layer's public inputs (past the inner VK prefix) changed."""
        ir, cfg, vk = chain.final_shape(mode)
        k = len(chain.final_shape(mode - 1)[2])  # mode 0: the scheduler
        return not pk.verify(ir, vk, pi_bumped(proof, k), cfg, device=dev)

    msm_before = dict(native.MSM_CALLS)
    # 1. the five modes over the stand-in scheduler (tests/test_compression)
    scfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=2,
                             final_fri_size=8)
    red = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=1,
                            final_fri_size=8)
    qir = qc.queue_ir(5)
    qsetup = qc.queue_setup(qir, scfg, device=dev)
    qproof = pk.prove(qir, qsetup, qc.queue_witness(
        qir, [[i + 1 for i in range(8)]], device=dev), scfg, device=dev)
    same("wrap_standin_scheduler", qsetup.vk(), qproof)
    chain5 = ly.CompressionChain(qir, scfg, qsetup.vk(),
                                 outer_cfgs={m: red for m in range(1, 6)},
                                 device=dev)
    src5 = InMemoryDataSource()
    out5 = cmp.wrap_proof(qproof, qproof.public_inputs[:4],
                          cmp.WrapperConfig(5), chain5.prove_fn,
                          chain5.verify_fn, src5)
    for mode in range(1, 6):
        same(f"wrap_standin_mode{mode}", chain5.final_shape(mode)[2],
             src5.get_compression_proof(mode) if mode < 5
             else out5["final_proof"])
    if not refused_past_vk(chain5, 5, out5["final_proof"]):
        raise SystemExit("wrap_golden: a tampered mode-5 proof verified")
    lap("five_modes")
    # 2. mode 1 at LDE 32 over the golden tower's scheduler
    sir, svk = gres.recursion_rigs[("scheduler",)]
    srec = gres.source.get_scheduler_proof()
    sched_pi = [int(v) for v in srec["scheduler_pi"]]
    chain1 = ly.CompressionChain(sir, gcfg, svk, device=dev)
    out1 = cmp.wrap_proof(srec["proof"], sched_pi, cmp.WrapperConfig(1),
                          chain1.prove_fn, chain1.verify_fn)
    same("wrap_mode1", out1["final_vk"], out1["final_proof"])
    if not refused_past_vk(chain1, 1, out1["final_proof"]):
        raise SystemExit("wrap_golden: a tampered mode-1 proof verified")
    lap("mode1")
    # 3. the "pi" SNARK proof of the scheduler's public inputs
    wsetup = sw.wrapper_setup()
    sproof = sw.wrap_scheduler_pi(wsetup, sched_pi)
    if convert.plonk_vk_to_json(wsetup.vk) != golden_json(
            "wrap_snark_pi_vk.json") or convert.plonk_proof_to_json(
            sproof) != golden_json("wrap_snark_pi_proof.json"):
        raise SystemExit("wrap_golden: the SNARK VK or proof differs")
    if not sw.verify_wrapped_proof(wsetup.vk, sproof,
                                   expected_scheduler_pi=sched_pi):
        raise SystemExit("wrap_golden: the SNARK proof does not verify")
    lap("snark")
    # 4. the blob branch at the testing domain
    want = golden_json("eip4844_golden.json")
    settings = kzg.KzgSettings.testing(16)
    if [list(p) for p in settings.g1_lagrange_brp] != \
            want["settings"]["g1_lagrange_brp"]:
        raise SystemExit("wrap_golden: the testing KZG settings differ")
    wit = w4844.generate_eip4844_witness(bytes.fromhex(want["blob"]),
                                         settings)
    if convert.eip4844_witness_to_json(wit) != want["witness"]:
        raise SystemExit("wrap_golden: the blob's witness chain differs")
    x = int.from_bytes(keccak256(wit[1] + wit[2])[16:], "big") % kzg.R
    elements = [int.from_bytes(c, "little") for c in wit[0]]
    if x != want["x"] or elements != want["elements"]:
        raise SystemExit("wrap_golden: the blob's point or elements differ")
    with ly.engine_override(gcfg):
        bsd, _ = ly.create_eip4844_setup_data(16, limb_bits=8, device=dev)
        bproof = ly.prove_eip4844(elements, x, n_elements=16, limb_bits=8,
                                  device=dev)
        ok = ly.verify_eip4844(elements, x, bproof, n_elements=16,
                               limb_bits=8, device=dev)
    if not ok:
        raise SystemExit("wrap_golden: the blob proof does not verify")
    same("eip4844_n16", bsd.vk, bproof)
    lap("eip4844")
    # 5. the full chain over the golden tower's block with that blob in the
    # scheduler's blob slot: scheduler, mode 1 at LDE 32 and the SNARK
    bchain = fc.prove_block_full_chain(
        golden.tower_block(isa), chain_types=(8,), base_cfg=gcfg,
        recursion_cfg=gcfg, blobs=[bytes.fromhex(want["blob"])],
        blob_kzg_settings=settings, device=dev)
    summary = golden_json("wrap_blob_summary.json")
    same("wrap_blob_scheduler", bchain.scheduler.vk, bchain.scheduler.proof)
    same("wrap_blob_mode1", bchain.final["final_vk"],
         bchain.final["final_proof"])
    if [int(v) for v in bchain.scheduler_pi] != summary["scheduler_pi"] or \
            str(bchain.final["snark_public_input"]) != \
            summary["snark_public_input"] or \
            convert.plonk_proof_to_json(bchain.snark["proof"]) != \
            golden_json("wrap_blob_snark_pi_proof.json"):
        raise SystemExit("wrap_golden: the blob chain's scheduler PIs or "
                         "SNARK proof differ from the golden JSON")
    if bchain.block.source.get_scheduler_proof()["num_blob_slots"] != 1:
        raise SystemExit("wrap_golden: the blob chain's scheduler has no "
                         "blob slot")
    lap("blob_chain")
    msm_runs = {k: native.MSM_CALLS[k] - msm_before[k] for k in msm_before}
    if min(msm_runs.values()) <= 0:
        raise SystemExit(f"wrap_golden: a native MSM did not run: {msm_runs}")
    phase("wrap_golden", vk_equal=True, proof_equal=True, verify=True,
          tampered_rejected=True, standin_scheduler_config=dataclasses.asdict(
              scfg), standin_mode_config=dataclasses.asdict(red),
          mode1_config=dataclasses.asdict(ly.compression_engine_config(1)),
          modes={m: rounded(st) for m, st in chain5.stats.items()},
          mode1=rounded(chain1.stats[1]),
          blob_chain={k: rounded(v) for k, v in bchain.stats.items()},
          blob_chain_scheduler_pi=summary["scheduler_pi"],
          native_msm_runs=msm_runs,
          seconds=laps)


def fw_tampered(proof, what):
    """A copy of a for-wrapper proof with one value changed: an inner
    public input, a digest of the witness cap, an OOD value or an opened
    witness value."""
    bad = copy.deepcopy(proof)
    if what == "public_input":
        bad.public_inputs[0] = (int(bad.public_inputs[0]) + 1) % GOLDILOCKS_P
    elif what == "cap":
        bad.witness_cap[0] = int(bad.witness_cap[0]) + 1
    elif what == "ood":
        c0, c1 = bad.ood_witness[0]
        bad.ood_witness[0] = ((int(c0) + 1) % GOLDILOCKS_P, c1)
    else:
        idx = sorted(bad.openings["witness"])[0]
        row = list(bad.openings["witness"][idx])
        row[0] = (int(row[0]) + 1) % GOLDILOCKS_P
        bad.openings["witness"][idx] = row
    return bad


FW_TAMPERS = ("public_input", "cap", "ood", "opening")


def fw_golden_phase(dev, phase, gres, gcfg, golden_json, rounded):
    """Phase `fw_golden`: made on the card, equal to the JAX package's bytes
    (tools/gen_fw_golden.py): the for-wrapper proof of the `queue_ir(5)`
    stand-in; the "full" SNARK statement over it (its digests equal the JAX
    package's, every gate holds); compression mode 1 for the wrapper at
    `for_wrapper_engine_config(1)` over the golden tower's scheduler proof
    `gres` made; the "binding" SNARK over that mode's Fr VK and the
    scheduler's public inputs. Four tampered copies of the stand-in proof
    are refused by the STARK verifier and by the statement's gate check.
    Returns the phase's launches."""
    import torch

    from zkevm_harness_tpu_torch import convert
    from zkevm_harness_tpu_torch.circuits import queue_circuit as qc
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.ops import ntt as nt
    from zkevm_harness_tpu_torch.prover import compression as cmp
    from zkevm_harness_tpu_torch.prover import hash_backend as hb
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde
    from zkevm_harness_tpu_torch.utils import snark_fri_verifier as sfv
    from zkevm_harness_tpu_torch.utils import snark_wrapper as sw

    t0 = time.time()
    laps = {}

    def lap(name):
        torch.cuda.synchronize()
        laps[name + "_s"] = round(time.time() - t0 - sum(laps.values()), 3)

    def same(stem, vk, proof):
        if [int(v) for v in vk] != golden_json(f"{stem}_vk.json") or \
                json.loads(json.dumps(serde.proof_to_json(proof))) != \
                golden_json(f"{stem}_proof.json"):
            raise SystemExit(f"fw_golden: {stem} differs from the golden "
                             "JSON")

    ck.reset_launches()
    # 1. the stand-in for the wrapper (tests/test_snark_fri_verifier.py)
    scfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=2,
                             final_fri_size=8)
    qir = qc.queue_ir(5)
    qsetup = qc.queue_setup(qir, scfg, device=dev)
    backend = hb.Bn254Backend(dev)
    tree = backend.commit_rows(nt.coset_lde(gl.concatenate(
        [qsetup.const_cols, qsetup.sigma_cols, qsetup.table_cols], axis=0),
        scfg.rate), scfg.cap_size)
    vk = tree.cap
    proof = pk.prove(qir, qsetup, qc.queue_witness(
        qir, [[i + 1 for i in range(8)]], device=dev), scfg,
        backend=backend, backend_setup=(vk, tree), device=dev)
    same("fw_standin", vk, proof)
    if not pk.verify(qir, vk, proof, scfg, device=dev, backend=backend):
        raise SystemExit("fw_golden: the stand-in proof does not verify")
    lap("standin")
    # 2. the "full" statement over the card's stand-in proof
    stats = sfv.gate_check_fw(qir, scfg, vk, proof)
    b, lay, _circ = sfv.build_cached(qir, scfg, len(vk))
    wires, pis = b.fill(sfv.fill_fw_assignments(lay, qir, scfg, vk, proof))
    digests = convert.plonk_statement_digests(b, wires, pis)
    want = golden_json("fw_full_statement.json")
    if any(digests[k] != want[k] for k in digests) or \
            [str(v) for v in pis] != want["public_inputs"]:
        raise SystemExit("fw_golden: the full statement differs from the "
                         "JAX package's")
    tamper = {}
    for what in FW_TAMPERS:
        bad = fw_tampered(proof, what)
        stark = not pk.verify(qir, vk, bad, scfg, device=dev,
                              backend=backend)
        try:
            sfv.gate_check_fw(qir, scfg, vk, bad)
            gates = False
        except AssertionError:
            gates = True
        tamper[what] = {"stark_refused": stark, "gates_refused": gates}
    if not all(all(v.values()) for v in tamper.values()):
        raise SystemExit(f"fw_golden: a tampered proof passed: {tamper}")
    lap("full_statement")
    # 3. mode 1 for the wrapper over the golden tower's scheduler
    sir, svk = gres.recursion_rigs[("scheduler",)]
    srec = gres.source.get_scheduler_proof()
    sched_pi = [int(v) for v in srec["scheduler_pi"]]
    chain = ly.CompressionChain(sir, gcfg, svk, wrapper_mode=1, device=dev)
    out = cmp.wrap_proof(srec["proof"], sched_pi, cmp.WrapperConfig(1),
                         chain.prove_fn, chain.verify_fn)
    same("fw_mode1", out["final_vk"], out["final_proof"])
    lap("mode1")
    # 4. the binding SNARK over mode 1's Fr VK
    bsetup, bproof = sw.wrap_with_binding(out["final_vk"], sched_pi)
    if convert.plonk_vk_to_json(bsetup.vk) != golden_json(
            "fw_binding_snark_vk.json") or convert.plonk_proof_to_json(
            bproof) != golden_json("fw_binding_snark_proof.json"):
        raise SystemExit("fw_golden: the binding SNARK differs")
    if not sw.verify_binding_proof(bsetup.vk, bproof,
                                   expected_fw_vk=out["final_vk"],
                                   expected_scheduler_pi=sched_pi):
        raise SystemExit("fw_golden: the binding SNARK does not verify")
    lap("binding")
    launches = dict(ck.LAUNCHES)
    for name in ("bn254_hash_rows", "bn254_hash_pairs"):
        if launches[name] <= 0:
            raise SystemExit(f"fw_golden launched {name} no time")
    phase("fw_golden", vk_equal=True, proof_equal=True, verify=True,
          standin_config=dataclasses.asdict(scfg),
          mode1_config=dataclasses.asdict(ly.for_wrapper_engine_config(1)),
          full_statement=dict(digests, gate_check=True,
                              sections=stats.get("sections")),
          tampered_rejected=tamper, mode1=rounded(chain.stats[1]),
          binding_gates=bsetup.circuit.num_gates, binding_n=bsetup.vk.n,
          seconds=laps, launches=launches)
    return launches


def eip4844_phase(dev, phase, bcfg, rounded):
    """Phase `eip4844`: the blob circuit at full width (4,096 elements, u8
    limbs) at the chain's base config, elements and point drawn from a
    seed: setup, prove and verify with the expected public inputs; the
    STARK verifier refuses the public inputs of a tampered element, a
    tampered opening value and a tampered OOD value. Returns the
    path's launches and the circuit's (width, log_n)."""
    import numpy as np
    import torch

    from zkevm_harness_tpu_torch.circuits import eip4844_circuit as e4
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import tracing

    n, fr = 4096, e4.FR_MODULUS
    limbs = np.random.default_rng(4096).integers(
        0, 1 << 62, size=(n + 1, 5), dtype=np.uint64).tolist()
    draws = [sum(int(v) << (62 * k) for k, v in enumerate(row)) % fr
             for row in limbs]
    elements, x = draws[:n], draws[n]
    ck.reset_launches()
    t_path = time.time()
    watch = tracing.Stopwatch(dev)
    with ly.engine_override(bcfg):
        sd, prog = ly.create_eip4844_setup_data(n, limb_bits=8, device=dev)
        watch.lap("setup")
        proof = ly.prove_eip4844(elements, x, n_elements=n, limb_bits=8,
                                 device=dev)
        watch.lap("prove")
        ok = ly.verify_eip4844(elements, x, proof, n_elements=n,
                               limb_bits=8, device=dev)
        watch.lap("verify")
        stats = watch.done(log_n=sd.ir.log_n, width=sd.ir.num_witness,
                           const_columns=sd.ir.num_const,
                           rows=prog.layout.num_rows,
                           public_inputs=len(proof.public_inputs))
        torch.cuda.synchronize()
        path_s = time.time() - t_path
        launches = dict(ck.LAUNCHES)
        # each tampered proof goes to the STARK verifier itself: the
        # public inputs of another element, another opening value, and
        # one OOD value changed under the expected public inputs
        bad_el = list(elements)
        bad_el[7] = (bad_el[7] + 1) % fr
        other = e4.expected_public_inputs(
            prog, e4.instance_inputs(bad_el, x, device=dev))
        bad_pis = copy.deepcopy(proof)
        bad_pis.public_inputs = [int(v) % gl.P for v in other]
        bad_ood = copy.deepcopy(proof)
        c0, c1 = bad_ood.ood_witness[3]
        bad_ood.ood_witness[3] = ((int(c0) + 1) % gl.P, c1)

        def refused(bad):
            return not pk.verify(sd.ir, sd.vk, bad, sd.config, device=dev)

        tamper = {"element": refused(bad_pis),
                  "opening": refused(pi_bumped(proof,
                                               len(proof.public_inputs) - 1)),
                  "ood_witness": refused(bad_ood)}
    if not ok or not all(tamper.values()):
        raise SystemExit(f"eip4844: verify {ok}, tampered refused {tamper}")
    for name in ("gl_mul", "poseidon2_permute"):
        if launches[name] <= 0:
            raise SystemExit(f"eip4844 path launched {name} no time")
    opening = e4.opening_value(prog, proof.public_inputs)
    if opening != e4.horner_fold(elements, x):
        raise SystemExit("eip4844: the proven opening is not the fold")
    phase("eip4844", n_elements=n, limb_bits=8, config=dataclasses.asdict(
        bcfg), stats=rounded(stats), path_s=round(path_s, 3), verify=True,
        public_inputs_expected=True, tampered_rejected=tamper,
        launches=launches)
    del sd, prog, proof, bad_pis, bad_ood
    ly._SETUP_CACHE.clear()
    torch.cuda.empty_cache()
    return launches, (stats["width"], stats["log_n"])


# key sets of the reference's proof and VK JSON, as tests/test_ref_serde.py
# states them (test_proofs/base_layer/basic_circuit_proof_10_0.json,
# setup/base_layer/vk_1.json)
REFERENCE_PROOF_KEYS = {
    "proof_config", "public_inputs", "witness_oracle_cap",
    "stage_2_oracle_cap", "quotient_oracle_cap", "final_fri_monomials",
    "values_at_z", "values_at_z_omega", "values_at_0",
    "fri_base_oracle_cap", "fri_intermediate_oracles_caps",
    "queries_per_fri_repetition", "pow_challenge", "_marker",
}
REFERENCE_VK_KEYS = {"fixed_parameters", "setup_merkle_tree_cap"}
REFERENCE_FIXED_KEYS = {
    "parameters", "lookup_parameters", "domain_size", "total_tables_len",
    "public_inputs_locations", "extra_constant_polys_for_selectors",
    "table_ids_column_idxes", "quotient_degree", "selectors_placement",
    "fri_lde_factor", "cap_size",
}
# production VKs generate-vks writes in phase `cli`, held against these
PROD_VK_TYPES = (1, 5, 7, 10)


def run_cli_batch(jobs, tmp, counts=None):
    """Run `python -m zkevm_harness_tpu_torch *argv` for each (argv,
    expect_rc, counted) of `jobs`, all at once, each in a process of its
    own from the repo's root, on the card. Returns a list of (standard
    output, wall seconds of that process). The kernel launches of each
    counted process are added to `counts`. Fails unless every process exits
    with its `expect_rc`."""
    env = dict(os.environ, PYTHONPATH=REPO_DIR)
    env.pop("ZKEVM_LAUNCHES_FILE", None)
    procs = []
    for i, (argv, _rc, counted) in enumerate(jobs):
        job_env = dict(env)
        launches_file = os.path.join(tmp, f"launches_{i}.json")
        if counted:
            job_env["ZKEVM_LAUNCHES_FILE"] = launches_file
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "zkevm_harness_tpu_torch", *argv],
            cwd=REPO_DIR, env=job_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.time(), launches_file))
    done = [None] * len(procs)

    def wait(i):
        # each process's own end, whichever of them ends first
        proc, t0, _f = procs[i]
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        done[i] = (stdout, stderr, time.time() - t0)

    waiters = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    out = []
    for (argv, rc, counted), (proc, _t, launches_file), (stdout, stderr,
                                                         secs) in zip(
            jobs, procs, done):
        if proc.returncode != rc:
            raise SystemExit(f"cli {' '.join(argv)}: exit {proc.returncode}, "
                             f"want {rc}: {stderr[-3000:]}")
        if counted:
            with open(launches_file) as f:
                for k, v in json.load(f).items():
                    counts[k] = counts.get(k, 0) + v
            os.remove(launches_file)
        out.append((stdout, secs))
    return out


def run_cli(argv, tmp, counts=None, expect_rc=0):
    """One command of `run_cli_batch`, its launches added to `counts` when
    that is a dict. Returns (standard output, wall seconds)."""
    return run_cli_batch([(argv, expect_rc, counts is not None)], tmp,
                         counts)[0]


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def tampered_proof_file(path, out):
    """A copy of a CLI proof file with its first public input changed."""
    with open(path) as f:
        blob = json.load(f)
    pis = blob["proof"]["fields"]["public_inputs"]
    pis[0] = str((int(pis[0]) + 1) % GOLDILOCKS_P)
    with open(out, "w") as f:
        json.dump(blob, f)
    return out


def cli_verify_round(tmp, proof_path, counts, shape=(), more=()):
    """verify on the proof (VALID, exit 0) and on a tampered copy (INVALID,
    exit 1), each in a process of its own, the two at once, beside the
    `run_cli_batch` jobs of `more`. Returns their seconds and the outputs
    of `more`."""
    bad = tampered_proof_file(proof_path, os.path.join(tmp, "tampered.json"))
    jobs = [(["verify", *shape, "--proof", proof_path], 0, True),
            (["verify", *shape, "--proof", bad], 1, True), *more]
    (ok_text, ok_s), (bad_text, bad_s), *rest = run_cli_batch(jobs, tmp,
                                                              counts)
    if ok_text != "VALID\n" or bad_text != "INVALID\n":
        raise SystemExit(f"cli verify printed {ok_text!r} and, on a "
                         f"tampered proof, {bad_text!r}")
    return ok_s, bad_s, rest


def cli_phases(args, phase, tmp):
    """Phases `cli_golden` and `cli`: the port's CLI run as processes of
    their own on the card. `cli_golden`: `prove` at log_n 8 x 16 writes the
    JAX CLI's file byte for byte, `verify` accepts it and refuses a tampered
    copy, `geometry` (and `--measured`) print the JAX CLI's JSON,
    `generate-vks --types 8 --recursion` writes its VKs and `prove-block
    --types 8` its scheduler, compression and SNARK proofs and block
    commitment (test_artifacts/cli_*); these check runs go side by side.
    `cli`, one command at a time: `prove` at the flagship's full
    width, `verify` in a second process, a tampered copy refused; the
    production VKs of types 1, 5, 7 and 10 from `generate-vks --geometry
    production` equal the committed ones; `bench-kernels`. Returns the
    kernel launches of both phases' processes (bench-kernels apart)."""
    # -- cli_golden: five commands at once, then the two verifies ----------
    counts_golden = {}
    out = os.path.join(tmp, "cli_prove_log8_w16.json")
    vks = os.path.join(tmp, "vks_testing")
    blk = os.path.join(tmp, "block")
    jobs = {"prove": (["prove", "--log-n", "8", "--width", "16", "--seed",
                       "0", "--out", out], 0, True),
            "geometry": (["geometry"], 0, False),
            "geometry --measured": (["geometry", "--measured"], 0, False),
            "generate_vks": (["generate-vks", "--types", "8", "--recursion",
                              "--out", vks], 0, True),
            "prove_block": (["prove-block", "--types", "8", "--out", blk], 0,
                            True)}
    ran = dict(zip(jobs, run_cli_batch(list(jobs.values()), tmp,
                                       counts_golden)))
    secs = {k: v[1] for k, v in ran.items()}
    if file_bytes(out) != file_bytes(os.path.join(
            GOLDEN_DIR, "cli_prove_log8_w16.json")):
        raise SystemExit("cli_golden: the prove file differs from the JAX "
                         "CLI's")
    secs["verify"], secs["verify_tampered"], _ = cli_verify_round(
        tmp, out, counts_golden)
    for key, name in (("geometry", "cli_geometry.txt"),
                      ("geometry --measured", "cli_geometry_measured.txt")):
        if ran[key][0].encode() != file_bytes(os.path.join(GOLDEN_DIR, name)):
            raise SystemExit(f"cli_golden: {key} printed another text than "
                             "the JAX CLI")
    for what, rel in (("base", "setup/base_layer/vk_8.json"),
                      ("leaf", "setup/recursion_layer/vk_10.json"),
                      ("node", "setup/recursion_layer/vk_2.json")):
        if file_bytes(os.path.join(vks, rel)) != file_bytes(os.path.join(
                GOLDEN_DIR, f"cli_vks8_{what}_vk.json")):
            raise SystemExit(f"cli_golden: the {what} VK differs")
    with open(os.path.join(GOLDEN_DIR, "cli_block_summary.json")) as f:
        commitment = json.load(f)["block_commitment"]
    if f"block commitment: {commitment}\n" not in ran["prove_block"][0]:
        raise SystemExit("cli_golden: the block commitment differs")
    for what, rel in (
            ("scheduler", "test_proofs/recursion_layer/scheduler_proof.json"),
            ("compression", "test_proofs/aux_layer/compression_proof_1.json"),
            ("snark", "test_proofs/aux_layer/wrapper_proof.json")):
        if file_bytes(os.path.join(blk, rel)) != file_bytes(os.path.join(
                GOLDEN_DIR, f"cli_block_{what}_proof.json")):
            raise SystemExit(f"cli_golden: the {what} proof file differs")
    # the wall seconds of each process, the five of the first batch side by
    # side on the card and the host
    phase("cli_golden", prove_equal=True, verify=True, tampered_rejected=True,
          geometry_equal=True, vks_equal=True, block_equal=True,
          seconds_side_by_side={k: round(v, 3) for k, v in secs.items()},
          launches=counts_golden)

    # -- cli: the flagship at full width, production VKs, bench-kernels ----
    counts = {}
    shape = ["--log-n", str(args.log_n), "--width", str(WIDTH)]
    out = os.path.join(tmp, "cli_prove_full.json")
    _, prove_s = run_cli(["prove", *shape, "--out", out], tmp, counts)
    # both verifies and generate-vks at once, for the script's time: each
    # command's seconds are its process's, side by side
    vks = os.path.join(tmp, "vks_production")
    verify_s, tampered_s, [(text, vks_s)] = cli_verify_round(
        tmp, out, counts, shape, more=[(
            ["generate-vks", "--geometry", "production", "--types",
             ",".join(str(t) for t in PROD_VK_TYPES), "--out", vks], 0,
            True)])
    per_type = {}
    for line in text.splitlines():
        # [vks] base[t] vk written (2^a x w, 1.2s, sha256 ...)
        if line.startswith("[vks] base["):
            t = int(line.split("[", 2)[2].split("]")[0])
            inner = line.split("(", 1)[1].split(",")
            per_type[t] = {"shape": inner[0],
                           "seconds": float(inner[1].strip().rstrip("s"))}
    for t in PROD_VK_TYPES:
        got = file_bytes(os.path.join(vks, f"setup/base_layer/vk_{t}.json"))
        with open(os.path.join(GOLDEN_DIR, f"vk_{t}_production.json")) as f:
            if json.loads(got) != json.load(f):
                raise SystemExit(f"cli: the production VK of type {t} "
                                 "differs from the committed one")
        per_type[t]["vk_equal"] = f"test_artifacts/vk_{t}_production.json"
    text, bench_s = run_cli(["bench-kernels"], tmp)
    bench = [json.loads(line) for line in text.splitlines()
             if line.startswith("{")]
    for name in ("gl_mul", "poseidon2_permute"):
        if counts.get(name, 0) <= 0:
            raise SystemExit(f"cli launched {name} no time")
    phase("cli", log_n=args.log_n, width=WIDTH,
          config={"rate": 2, "cap_size": 16, "num_queries": 40,
                  "final_fri_size": 64},
          prove_s=round(prove_s, 3), verify_s=round(verify_s, 3),
          verify_tampered_s=round(tampered_s, 3), verify=True,
          tampered_rejected=True, proof_bytes=os.path.getsize(out),
          generate_vks_s=round(vks_s, 3), production_vks=per_type,
          bench_kernels_s=round(bench_s, 3), bench_kernels=bench,
          launches=counts)
    return counts_golden, counts


def stark_phases(dev, phase):
    """Phases `stark_golden` and `stark`: the fib-mul AIR of the JAX
    package's STARK tests proved on the card at log_n 6 under the golden
    config, equal to test_artifacts/stark_fib_log6_proof.json; then at 2^20
    rows under `StarkConfig()` (LDE 4, cap 16, 40 queries, final 32): prove,
    verify, a tampered OOD value, opening and trace refused; seconds per
    stage, `_zh_over_last_inv` timed apart (the device form the prover runs
    and the JAX package's host-int form); launches and peak memory. Returns
    the launches of the 2^20 prove and verify."""
    import numpy as np
    import torch

    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import stark as st
    from zkevm_harness_tpu_torch.utils import serde, tracing

    P = gl.P

    def air(log_n):
        return st.Air(width=3, log_n=log_n, constraint_degree=2,
                      num_transitions=3,
                      eval_transitions=golden.fib_mul_transitions,
                      boundary=golden.FIB_MUL_BOUNDARY)

    def trace(log_n):
        return gl.from_int(np.array(golden.fib_mul_trace(log_n),
                                    dtype=object), dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    # -- stark_golden -------------------------------------------------------
    g_log_n = golden.STARK_GOLDEN_LOG_N
    gcfg = st.StarkConfig(**golden.STARK_GOLDEN_CONFIG)
    gproof, golden_s = timed(lambda: st.prove(air(g_log_n), trace(g_log_n),
                                              gcfg, device=dev))
    with open(os.path.join(GOLDEN_DIR,
                           f"stark_fib_log{g_log_n}_proof.json")) as f:
        if json.loads(json.dumps(serde.proof_to_json(gproof))) != json.load(f):
            raise SystemExit("stark_golden: proof differs from the golden "
                             "JSON")
    if not st.verify(air(g_log_n), gproof, gcfg, device=dev, strict=True):
        raise SystemExit("stark_golden: proof does not verify")
    phase("stark_golden", log_n=g_log_n, config=golden.STARK_GOLDEN_CONFIG,
          proof_equal=True, verify=True, seconds=round(golden_s, 3))

    # -- stark: 2^20 rows ---------------------------------------------------
    log_n = 20
    cfg = st.StarkConfig()
    big_air = air(log_n)
    tr, trace_s = timed(lambda: trace(log_n))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracing.GLOBAL.enabled = True
    tracing.GLOBAL.sync = torch.cuda.synchronize
    tracing.GLOBAL.spans.clear()
    ck.reset_launches()
    proof, prove_s = timed(lambda: st.prove(big_air, tr, cfg, device=dev))
    ok, verify_s = timed(lambda: st.verify(big_air, proof, cfg, device=dev,
                                           strict=True))
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in
              tracing.GLOBAL.flat_durations().items() if k.startswith("stark")}
    tracing.GLOBAL.enabled = False
    if not ok:
        raise SystemExit("stark: proof does not verify")
    for name in ("gl_mul", "poseidon2_permute"):
        if launches[name] <= 0:
            raise SystemExit(f"stark launched {name} no time")
    n, lde, shift = 1 << log_n, cfg.lde_factor, gl.MULTIPLICATIVE_GENERATOR
    _, zh_device_s = timed(lambda: st._zh_over_last_inv(n, lde, shift, dev))

    def zh_host():
        # the JAX package's form: the (x_i - w^{N-1}) vector from host ints
        n_lde = n * lde
        v = gl.primitive_root_of_unity(n_lde.bit_length() - 1)
        w_last = pow(gl.primitive_root_of_unity(log_n), n - 1, P)
        xs = gl.powers_host(v, n_lde).astype(object)
        return gl.from_int((xs * shift - w_last) % P, dev)

    xml_host, zh_host_s = timed(zh_host)
    if not torch.equal(xml_host, st._zh_over_last_inv(n, lde, shift, dev)[1]):
        raise SystemExit("stark: the device form of (x - w^{N-1}) differs "
                         "from the host ints")
    del xml_host

    def refused(mutate):
        bad = copy.deepcopy(proof)
        mutate(bad)
        return not st.verify(big_air, bad, cfg, device=dev)

    def bump_ood(p):
        p.ood_trace[0] = ((p.ood_trace[0][0] + 1) % P, p.ood_trace[0][1])

    def bump_opening(p):
        k = sorted(p.trace_openings)[0]
        p.trace_openings[k] = [(p.trace_openings[k][0] + 1) % P] + \
            list(p.trace_openings[k][1:])

    bad_trace = tr.clone()
    bad_trace[2, n // 2] ^= 1
    bad_proof = st.prove(big_air, bad_trace, cfg, device=dev)
    del bad_trace
    rejected = {"ood": refused(bump_ood), "opening": refused(bump_opening),
                "wrong_trace": not st.verify(big_air, bad_proof, cfg,
                                             device=dev)}
    if not all(rejected.values()):
        raise SystemExit(f"stark: a tampered proof was accepted: {rejected}")
    del tr, bad_proof
    torch.cuda.empty_cache()
    phase("stark", log_n=log_n, width=3, config=dataclasses.asdict(cfg),
          trace_s=round(trace_s, 3), prove_s=round(prove_s, 3),
          verify_s=round(verify_s, 3), verify=True,
          zh_over_last_inv_device_s=round(zh_device_s, 4),
          zh_over_last_inv_host_s=round(zh_host_s, 4), stages_s=stages,
          tampered_rejected=rejected, max_memory_allocated=peak,
          launches=launches)
    return launches


def gadgets_golden_phase(dev, phase):
    """Phase `gadgets_golden`: the five gadget circuits (GF(p^2) squaring
    chain, inverse cells, FRI fold check, in-circuit transcript, Merkle
    path) made and proved on the card at the JAX tests' shapes: each VK and
    proof equals test_artifacts/gadget_*_{vk,proof}.json."""
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde

    t0 = time.time()
    names = []
    for name, ir, setup, witness, cfg in golden.gadget_circuits(dev):
        proof = pk.prove(ir, setup, witness, cfg, device=dev)
        with open(os.path.join(GOLDEN_DIR, f"gadget_{name}_vk.json")) as f:
            if setup.vk() != [int(v) for v in json.load(f)]:
                raise SystemExit(f"gadgets_golden: the {name} VK differs")
        with open(os.path.join(GOLDEN_DIR, f"gadget_{name}_proof.json")) as f:
            if json.loads(json.dumps(serde.proof_to_json(proof))) != \
                    json.load(f):
                raise SystemExit(f"gadgets_golden: the {name} proof differs")
        if not pk.verify(ir, setup.vk(), proof, cfg, device=dev, strict=True):
            raise SystemExit(f"gadgets_golden: the {name} proof does not "
                             "verify")
        names.append(name)
    phase("gadgets_golden", circuits=names, vk_equal=True, proof_equal=True,
          verify=True, seconds=round(time.time() - t0, 3))


def ref_serde_phase(dev, phase, ir, setup, proof, cfg):
    """Phase `ref_serde`: the main path's flagship proof (MainVM-shaped,
    exported as type 1) through the reference's JSON dialect and back
    verifies unchanged; the proof and VK documents hold the reference's key
    sets; a tampered document is refused."""
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import ref_serde as ref

    t0 = time.time()
    doc = json.loads(json.dumps(ref.proof_to_reference_json(1, proof, cfg)))
    body = doc["MainVM"]
    extras = set(body) - REFERENCE_PROOF_KEYS
    if not REFERENCE_PROOF_KEYS <= set(body) or not extras <= {
            "lookup_oracle_cap", "values_at_z_layout", "query_positions"}:
        raise SystemExit("ref_serde: the proof document's keys differ from "
                         "the reference's")
    vk_doc = ref.vk_to_reference_json(1, ir, setup, cfg)["MainVM"]
    if set(vk_doc) != REFERENCE_VK_KEYS or \
            set(vk_doc["fixed_parameters"]) != REFERENCE_FIXED_KEYS:
        raise SystemExit("ref_serde: the VK document's keys differ from the "
                         "reference's")
    ctype, back = ref.reference_json_to_proof(doc)
    if ctype != 1 or not pk.verify(ir, setup.vk(), back, cfg, device=dev,
                                   strict=True):
        raise SystemExit("ref_serde: the round-tripped proof does not verify")
    body["public_inputs"][0] = (body["public_inputs"][0] + 1) % GOLDILOCKS_P
    if pk.verify(ir, setup.vk(), ref.reference_json_to_proof(doc)[1], cfg,
                 device=dev):
        raise SystemExit("ref_serde: a tampered document verified")
    phase("ref_serde", circuit="flagship as MainVM", verify=True,
          tampered_rejected=True, document_bytes=len(json.dumps(doc)),
          extension_keys=sorted(extras), seconds=round(time.time() - t0, 3))


# ---------------------------------------------------------------------------
# Proving across cards: the ranks of parallel.mesh.run_on_mesh
# ---------------------------------------------------------------------------

MESH_GOLDEN = (6, 16, dict(rate=2, cap_size=4, num_queries=8,
                           final_fri_size=8))  # tests/test_mesh.py:82-84
MESH_DRYRUN = (9, 64, dict(rate=2, cap_size=8, num_queries=8,
                           final_fri_size=16))  # __graft_entry__.py:108-115
MESH_RANKS = 4  # golden, dry run and distributed NTT: one spawn
MESH_PROVE_RANKS = 2  # 130 columns: 65 a rank
MESH_NTT_LOG_N = 20  # the flagship's commitment domain at its 2^19 rows


class RankClock:
    """Inside a rank: each part of the sharded work started together (a
    barrier), closed after a synchronise; its seconds, its launches and the
    collective bytes it sent. Work outside `part` (the one-rank comparisons)
    is counted nowhere."""

    def __init__(self, mesh):
        from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
        self.mesh, self.ck = mesh, ck
        self.parts = {}

    def part(self, name, fn):
        import torch
        import torch.distributed as dist
        from zkevm_harness_tpu_torch.parallel import mesh as pm
        dev = self.mesh.device
        torch.cuda.synchronize(dev)
        dist.barrier()
        pm.reset_sent_bytes()
        before = dict(self.ck.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        self.parts[name] = {
            "s": time.perf_counter() - t0,
            "launches": {k: v - before[k]
                         for k, v in self.ck.LAUNCHES.items()},
            "sent": {label: dict(kinds)
                     for label, kinds in pm.SENT_BYTES.items()}}
        return out


def _mesh_draw(shape, dev):
    """tests/test_mesh.py's inputs: a fresh default_rng(0) a test."""
    import numpy as np
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    return gl.from_u64(np.random.default_rng(0).integers(
        0, 2**63, size=shape, dtype=np.uint64), dev)


def _mesh_flagship(mesh, log_n, width, cfg_kw):
    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    cfg = pk.PlonkishConfig(**cfg_kw)
    ir = fl.flagship_ir(log_n=log_n, width=width)
    return (ir, cfg, fl.flagship_setup(ir, cfg, device=mesh.device),
            fl.flagship_witness(ir, seed=0, device=mesh.device))


def mesh_rank_four():
    """Rank side of phases `mesh_golden`, `mesh_dryrun` and the distributed
    NTT of phase `mesh`, in one spawn of 4 ranks: each sharded result held
    against the one-rank function on the same inputs."""
    import numpy as np
    import torch
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.ops import merkle as mk
    from zkevm_harness_tpu_torch.ops import ntt as nt
    from zkevm_harness_tpu_torch.ops import poseidon2 as p2
    from zkevm_harness_tpu_torch.parallel import dist_ntt as dn
    from zkevm_harness_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    dev = mesh.device
    # a fresh process's first launches load the libraries and the card's
    # modules: seconds, kept out of the timed parts
    t0 = time.perf_counter()
    p2.permute(gl.mul(gl.ones((1, 12), dev), gl.ones((1, 12), dev)))
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    clock = RankClock(mesh)
    eq = {}

    def gathered(x, width):
        return pm.gather_columns(x, mesh, width)

    def domain(x):
        return pm.all_gather(x, mesh).permute(1, 0, 2).reshape(
            x.shape[0], -1)

    # -- mesh_golden: the five helpers at tests/test_mesh.py's shapes -------
    trace = _mesh_draw((16, 64), dev)
    got = clock.part("golden_lde", lambda: pm.sharded_coset_lde(
        pm.shard_columns(trace, mesh), 2, mesh))
    eq["lde"] = torch.equal(gathered(got, 16), nt.coset_lde(trace, 2))
    evals = _mesh_draw((8, 64), dev)
    got = clock.part("golden_leaf_hash", lambda: pm.sharded_leaf_hash(
        pm.shard_columns(evals, mesh), mesh))
    eq["leaf_hash"] = torch.equal(gathered(got, 64),
                                  mk.hash_leaves(evals.t()))
    states = _mesh_draw((16, 12), dev)
    got = clock.part("golden_poseidon", lambda:
                     pm.sharded_poseidon_throughput_step(
                         pm.shard_columns(states, mesh), mesh))
    eq["poseidon"] = torch.equal(gathered(got, 16), p2.permute(states))
    vals = _mesh_draw((3, 1024), dev)
    got = clock.part("golden_ntt", lambda: dn.distributed_ntt(
        dn.shard_domain(vals, mesh), mesh))
    eq["distributed_ntt"] = torch.equal(domain(got), nt.ntt(vals))
    cols = _mesh_draw((16, 64), dev)
    lde, digests, _levels, cap = clock.part(
        "golden_commit", lambda: pm.sharded_commit(
            pm.shard_columns(cols, mesh), 2, 8, mesh))
    want_lde = nt.coset_lde(cols, 2)
    want = mk.build_tree(mk.hash_leaves(want_lde.t()), 8)
    eq["commit"] = (torch.equal(gathered(lde, 16), want_lde)
                    and torch.equal(gathered(digests, 128), want.levels[0])
                    and torch.equal(cap, want.cap))
    ir, cfg, setup, witness = _mesh_flagship(mesh, *MESH_GOLDEN)
    golden_proof = clock.part("golden_prove", lambda: pm.prove_column_sharded(
        ir, setup, witness, cfg, mesh))

    # -- mesh_dryrun: __graft_entry__.dryrun_multichip's steps at D = 4 -----
    d = mesh.size
    rng = np.random.default_rng(0)
    trace = gl.from_u64(rng.integers(0, 2**63, size=(2 * d, 32 * d),
                                     dtype=np.uint64), dev)
    digests = clock.part("dryrun_commit_step", lambda: pm.sharded_leaf_hash(
        pm.sharded_coset_lde(pm.shard_columns(trace, mesh), 2, mesh), mesh))
    eq["dryrun_commit_step"] = torch.equal(
        gathered(digests, 64 * d), mk.hash_leaves(nt.coset_lde(trace, 2).t()))
    poly = gl.from_u64(rng.integers(0, 2**63, size=(2, max(256, 4 * d * d)),
                                    dtype=np.uint64), dev)
    got = clock.part("dryrun_distributed_ntt", lambda: dn.distributed_ntt(
        dn.shard_domain(poly, mesh), mesh))
    eq["dryrun_distributed_ntt"] = torch.equal(domain(got), nt.ntt(poly))
    ir, cfg, setup, witness = _mesh_flagship(mesh, *MESH_DRYRUN)
    dryrun_proof = clock.part("dryrun_prove", lambda: pm.prove_column_sharded(
        ir, setup, witness, cfg, mesh))
    del ir, cfg, setup, witness

    small_peak = torch.cuda.max_memory_allocated(dev)

    # -- mesh: the distributed NTT of (130, 2^20) ---------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = torch.randint(0, 2**63 - 1, (WIDTH, 1 << MESH_NTT_LOG_N),
                        generator=gen, device=dev)  # every value < p
    mine = dn.shard_domain(big, mesh).contiguous()
    for label in ("ntt_first", "ntt_warm"):
        got = clock.part(label, lambda: dn.distributed_ntt(mine, mesh))
    ntt_peak = torch.cuda.max_memory_allocated(dev)
    del mine
    blk = got.shape[1]
    eq["distributed_ntt_130"] = torch.equal(
        got, nt.ntt(big)[:, mesh.rank * blk:(mesh.rank + 1) * blk])
    return {"rank": mesh.rank, "backend": mesh.backend, "equal": eq,
            "load_s": load_s,
            "golden_proof": golden_proof, "dryrun_proof": dryrun_proof,
            "parts": clock.parts, "max_memory_allocated": small_peak,
            "ntt_max_memory_allocated": ntt_peak}


def mesh_rank_prove(log_n):
    """Rank side of phase `mesh`'s column-sharded prove of the main path's
    flagship (WIDTH x 2^log_n under its config), twice."""
    import torch
    from zkevm_harness_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh()
    clock = RankClock(mesh)
    ir, cfg, setup, witness = _mesh_flagship(
        mesh, log_n, WIDTH, dict(rate=2, cap_size=16, num_queries=40,
                                 final_fri_size=512))
    torch.cuda.reset_peak_memory_stats(mesh.device)
    proofs = [clock.part(label, lambda: pm.prove_column_sharded(
        ir, setup, witness, cfg, mesh)) for label in ("first", "warm")]
    return {"rank": mesh.rank, "backend": mesh.backend, "proofs": proofs,
            "parts": clock.parts,
            "max_memory_allocated": torch.cuda.max_memory_allocated(
                mesh.device)}


def mesh_phases(args, dev, phase, main_ir, main_vk, main_cfg, main_proof):
    """Phases `mesh_golden`, `mesh_dryrun` and `mesh`: the column-sharded
    prove and the distributed NTT in ranks of `run_on_mesh` (gloo with every
    rank on this card where the machine has fewer cards than ranks, nccl
    with a card a rank where it has enough). Returns the launches of the
    sharded work, every rank's summed."""
    import numpy as np
    import torch
    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import ntt as nt
    from zkevm_harness_tpu_torch.parallel import mesh as pm
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde

    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()

    def summed(results, labels):
        out = {k: 0 for k in ck.LAUNCHES}
        for r in results:
            for label in labels:
                for k, v in r["parts"][label]["launches"].items():
                    out[k] += v
        return out

    def per_rank(results, labels, what="s"):
        return [{label: (round(r["parts"][label]["s"], 4) if what == "s"
                         else r["parts"][label]["sent"])
                 for label in labels} for r in results]

    def same_json(proof, golden_name):
        with open(os.path.join(GOLDEN_DIR, golden_name)) as f:
            return json.loads(json.dumps(serde.proof_to_json(proof))) \
                == json.load(f)

    def check(results, keys):
        for r in results:
            bad = [k for k in keys if not r["equal"][k]]
            if bad:
                raise SystemExit(f"mesh: rank {r['rank']}: {bad} differ from "
                                 "the one-rank results")

    t0 = time.time()
    four = pm.run_on_mesh(mesh_rank_four, MESH_RANKS,
                          same=lambda r: (
                              serde.proof_to_json(r["golden_proof"]),
                              serde.proof_to_json(r["dryrun_proof"])))
    four_s = time.time() - t0
    backend4 = four[0]["backend"]

    # -- mesh_golden ---------------------------------------------------------
    check(four, ("lde", "leaf_hash", "poseidon", "distributed_ntt", "commit"))
    log_n, width, cfg_kw = MESH_GOLDEN
    gcfg = pk.PlonkishConfig(**cfg_kw)
    gir = fl.flagship_ir(log_n=log_n, width=width)
    gsetup = fl.flagship_setup(gir, gcfg, device=dev)
    proof = four[0]["golden_proof"]
    if not same_json(proof, "mesh_log6_w16_proof.json"):
        raise SystemExit("mesh_golden: the sharded proof differs from "
                         "test_artifacts/mesh_log6_w16_proof.json")
    if not pk.verify(gir, gsetup.vk(), proof, gcfg, device=dev, strict=True):
        raise SystemExit("mesh_golden: the sharded proof does not verify")
    glabels = ("golden_lde", "golden_leaf_hash", "golden_poseidon",
               "golden_ntt", "golden_commit", "golden_prove")
    phase("mesh_golden", backend=backend4, ranks=MESH_RANKS,
          cards=cards, helpers_equal=True, proof_equal=True, verify=True,
          shape=f"flagship 2^{log_n} x {width}", config=cfg_kw,
          spawn_wall_s=round(four_s, 3),
          rank_load_s=[round(r["load_s"], 4) for r in four],
          rank_s=per_rank(four, glabels),
          max_memory_allocated=[r["max_memory_allocated"] for r in four],
          collective_bytes=per_rank(four, ("golden_prove",), "sent"),
          launches=summed(four, glabels))

    # -- mesh_dryrun ---------------------------------------------------------
    check(four, ("dryrun_commit_step", "dryrun_distributed_ntt"))
    log_n, width, cfg_kw = MESH_DRYRUN
    dcfg = pk.PlonkishConfig(**cfg_kw)
    dir_ = fl.flagship_ir(log_n=log_n, width=width)
    dsetup = fl.flagship_setup(dir_, dcfg, device=dev)
    proof = four[0]["dryrun_proof"]
    if not same_json(proof, "mesh_log9_w64_proof.json"):
        raise SystemExit("mesh_dryrun: the sharded proof differs from "
                         "test_artifacts/mesh_log9_w64_proof.json")
    if not pk.verify(dir_, dsetup.vk(), proof, dcfg, device=dev):
        raise SystemExit("mesh_dryrun: the sharded proof does not verify")
    dwit = fl.flagship_witness(dir_, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one = pk.prove(dir_, dsetup, dwit, dcfg, device=dev)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    same_caps = np.array_equal(np.asarray(proof.witness_cap, dtype=object),
                               np.asarray(one.witness_cap, dtype=object))
    same_queries = (list(map(int, proof.fri.query_positions))
                    == list(map(int, one.fri.query_positions)))
    if not (same_caps and same_queries):
        raise SystemExit("mesh_dryrun: the sharded proof diverged from the "
                         "one-rank transcript")
    dlabels = ("dryrun_commit_step", "dryrun_distributed_ntt", "dryrun_prove")
    phase("mesh_dryrun", backend=backend4, ranks=MESH_RANKS,
          cards=cards,
          steps={"sharded_commit_step": [2 * MESH_RANKS,
                                         32 * MESH_RANKS],
                 "distributed_ntt": [2, max(256, 4 * MESH_RANKS ** 2)],
                 "prove": f"flagship 2^{log_n} x {width}", "config": cfg_kw},
          steps_equal=True, proof_equal=True, verify=True,
          same_caps_and_queries=True, rank_s=per_rank(four, dlabels),
          max_memory_allocated=[r["max_memory_allocated"] for r in four],
          one_rank_prove_s=round(one_s, 4),
          caveat="ranks that share one card can never beat one rank"
          if cards < MESH_RANKS else None,
          collective_bytes=per_rank(four, ("dryrun_prove",), "sent"),
          launches=summed(four, dlabels))

    # -- mesh: the main path's flagship over 2 ranks, the NTT over 4 ---------
    check(four, ("distributed_ntt_130",))
    t0 = time.time()
    two = pm.run_on_mesh(mesh_rank_prove, MESH_PROVE_RANKS, args.log_n,
                         same=lambda r: [serde.proof_to_json(p)
                                         for p in r["proofs"]])
    two_s = time.time() - t0
    want = serde.proof_to_json(main_proof)
    for p in two[0]["proofs"]:
        if serde.proof_to_json(p) != want:
            raise SystemExit("mesh: the sharded proof differs from phase "
                             "main_path's one-card proof")
    proof = two[0]["proofs"][0]
    if not pk.verify(main_ir, main_vk, proof, main_cfg, device=dev,
                     strict=True):
        raise SystemExit("mesh: the sharded proof does not verify")
    bad = copy.deepcopy(proof)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % GOLDILOCKS_P
    if pk.verify(main_ir, main_vk, bad, main_cfg, device=dev):
        raise SystemExit("mesh: a tampered public input verified")
    # the same (130, 2^20) on this card alone, for the record
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = torch.randint(0, 2**63 - 1, (WIDTH, 1 << MESH_NTT_LOG_N),
                        generator=gen, device=dev)
    one_ntt_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nt.ntt(big)
        torch.cuda.synchronize()
        one_ntt_s.append(round(time.perf_counter() - t1, 4))
    del big
    plabels = ("first", "warm")
    nlabels = ("ntt_first", "ntt_warm")
    phase("mesh", backend=two[0]["backend"], ranks=MESH_PROVE_RANKS,
          cards=cards, log_n=args.log_n, width=WIDTH,
          config=dataclasses.asdict(main_cfg), proof_equal_main=True,
          verify=True, tampered_rejected=True,
          prove_rank_s=per_rank(two, plabels),
          spawn_wall_s=round(two_s, 3),
          max_memory_allocated=[r["max_memory_allocated"] for r in two],
          collective_bytes=per_rank(two, ("first",), "sent"),
          launches=summed(two, plabels),
          distributed_ntt={
              "backend": backend4, "ranks": MESH_RANKS, "cards": cards,
              "shape": [WIDTH, 1 << MESH_NTT_LOG_N], "equal_ntt": True,
              "rank_s": per_rank(four, nlabels),
              "one_rank_ntt_s": one_ntt_s,
              "max_memory_allocated": [r["ntt_max_memory_allocated"]
                                       for r in four],
              "collective_bytes": per_rank(four, ("ntt_first",), "sent"),
              "launches": summed(four, nlabels)},
          caveat="ranks that share one card: no time here is a multi-card "
                 "speed-up" if cards < MESH_RANKS else None)
    total = summed(four, glabels + dlabels + nlabels)
    for k, v in summed(two, plabels).items():
        total[k] += v
    for name in ("gl_mul", "poseidon2_permute"):
        if total[name] <= 0:
            raise SystemExit(f"mesh path launched {name} no time")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=19,
                    help="rows of the main-path trace as a power of two "
                         "(>= 16); the width stays 130")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's per-kernel register and spill report")
    ap.add_argument("--profile", action="store_true",
                    help="prove each main path (and each hash circuit "
                         "phase `hashes` proves, and type 10 of phase "
                         "`block`) once more under torch.profiler, "
                         "and run the full chain once more under it, and "
                         "print the device's busy share and the top "
                         "kernels")
    ap.add_argument("--compare-broadcast", action="store_true",
                    help="prove again with the elementwise kernels' broadcast "
                         "operands materialised in PyTorch (all of them, and "
                         "all but scalars) and print the times beside the "
                         "in-kernel addressing's")
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="write cuobjdump's SASS of the built libraries into "
                         "DIR and print each kernel's instruction counts")
    ap.add_argument("--out", default=None,
                    help="also write all phase records to this JSON file, "
                         "and the production for-wrapper proof and the "
                         "production MainVM proof, each with its VK and a "
                         "summary, into fw_production/ and "
                         "main_vm_production/ beside it")
    args = ap.parse_args(argv)
    if args.log_n < 16:
        ap.error("--log-n must be at least 16")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import decommitter_circuit as cdcirc
    from zkevm_harness_tpu_torch.circuits import \
        decommitts_sorter_circuit as dscirc
    from zkevm_harness_tpu_torch.circuits import events_sorter_circuit as ecirc
    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.circuits import keccak_circuit as kcirc
    from zkevm_harness_tpu_torch.circuits import \
        linear_hasher_circuit as lhcirc
    from zkevm_harness_tpu_torch.circuits import log_demux_circuit as dcirc
    from zkevm_harness_tpu_torch.circuits import main_vm_circuit as mvc
    from zkevm_harness_tpu_torch.circuits import \
        ram_permutation_circuit as rcirc
    from zkevm_harness_tpu_torch.circuits import sha256_circuit as shcirc
    from zkevm_harness_tpu_torch.circuits import \
        storage_sorter_circuit as sscirc
    from zkevm_harness_tpu_torch.circuits.types import GeometryConfig
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.utils import serde, tracing
    from zkevm_harness_tpu_torch.utils.native import keccak256
    from zkevm_harness_tpu_torch.vm import isa
    from zkevm_harness_tpu_torch.witness import main_vm as wmv
    from zkevm_harness_tpu_torch.witness import oracle
    from zkevm_harness_tpu_torch.witness.log_demux import \
        compute_log_demux_artifacts
    from zkevm_harness_tpu_torch.witness.ram_permutation import \
        compute_ram_circuit_snapshots
    from zkevm_harness_tpu_torch.witness.decommitter import \
        compute_code_decommitter_artifacts
    from zkevm_harness_tpu_torch.witness.linear_hasher import (
        compute_hasher_circuit_artifacts, serialize_l1_message)
    from zkevm_harness_tpu_torch.witness.precompile_circuits import (
        compute_keccak_circuit_artifacts, compute_sha256_circuit_artifacts)
    from zkevm_harness_tpu_torch.witness.sorters import (
        compute_decommitts_circuit_artifacts, compute_events_circuit_artifacts,
        compute_storage_circuit_artifacts)

    t_start = time.time()
    records = []

    def phase(name, **fields):
        rec = {"phase": name, "at_s": round(time.time() - t_start, 1),
               **fields}
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
        # diagnostics of K3: what one pair hash, one permutation with its
        # conversions, executes; the full rounds' loops of 4 trips each hold
        # a loop of 3 (one S-box a trip), the partial rounds' loop has 56
        kernels = sass_counts(ck, args.sass)  # writes the .sass files
        counts = sass_dynamic_counts(
            os.path.join(args.sass, "poseidon2_bn254.sass"),
            "hash_pairs_kernel", (4, 3, 56, 4, 3)) or {}
        phase("sass", kernels=kernels,
              sass_alu_per_permutation=counts.get("alu"),
              sass_imad_per_permutation=counts.get("imad"))

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

    # the MainVM path's largest shapes: the whole trace (764 x 2^16) for the
    # elementwise kernels, the 2^17 leaves of a rate-2 commitment for the
    # permutation, and the lone state of the serial sponges
    mv_geo = ly.main_vm_geometry_for_capacity(MAIN_VM_CYCLES, limb_bits=16)
    mv_ir = mvc.main_vm_ir(mv_geo)
    mv_shape = (mv_ir.num_witness, mv_geo.n)
    mv_el = mv_shape[0] * mv_shape[1]
    ta, tb = rand_field(mv_shape), rand_field(mv_shape)
    timing_mv = {}
    for name, (kern, plain) in binary.items():
        errs[name] = max(errs[name], check_equal(
            name + " MainVM shape", kern(ta, tb), plain(ta, tb)))
        timing_mv[name] = {
            "shape": list(mv_shape),
            "ms": cuda_ms(lambda: kern(ta, tb), 2, 10),
            "plain_ms": cuda_ms(lambda: plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * mv_el,
            "ops": mv_el * (OPS_MUL if name == "gl_mul" else OPS_ADD)}
    del ta, tb
    mv_states = 2 * mv_geo.n
    ts = rand_field((mv_states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 MainVM shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing_mv["poseidon2_permute"] = {
        "shape": [mv_states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * mv_states,
        "ops": mv_states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    one = ts[:1].clone()
    del ts
    timing_mv["poseidon2_permute_one_state"] = {
        "shape": [1, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(one), 10, 200),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(one), 1, 2),
        "bytes": 2 * 8 * 12,
        "ops": P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD}
    # the memory and log path's shapes: a block of 1024 witness columns of a
    # 2^16-row coset (the demuxer's copy terms) for the elementwise
    # kernels, the 2^19 leaves of the RAM permutation's rate-2 commitment
    # for the permutation
    timing_srt = {}
    srt_shape = (1024, 1 << 16)
    ta, tb = rand_field(srt_shape), rand_field(srt_shape)
    for name, (kern, plain) in binary.items():
        errs[name] = max(errs[name], check_equal(
            name + " sorters shape", kern(ta, tb), plain(ta, tb)))
        timing_srt[name] = {
            "shape": list(srt_shape),
            "ms": cuda_ms(lambda: kern(ta, tb), 2, 10),
            "plain_ms": cuda_ms(lambda: plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * ta.numel(),
            "ops": ta.numel() * (OPS_MUL if name == "gl_mul" else OPS_ADD)}
    del ta, tb
    srt_states = 1 << 19
    ts = rand_field((srt_states, 12))
    errs["poseidon2_permute"] = max(errs["poseidon2_permute"], check_equal(
        "poseidon2 sorters shape", ck.poseidon2_permute(ts),
        ck.poseidon2_permute_plain(ts)))
    timing_srt["poseidon2_permute"] = {
        "shape": [srt_states, 12],
        "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), 2, 10),
        "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
        "bytes": 2 * 8 * 12 * srt_states,
        "ops": srt_states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
    del ts
    torch.cuda.empty_cache()
    for t in (list(timing.values()) + list(timing_mv.values())
              + list(timing_srt.values())):
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"

    def rounded(table):
        return {k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                    for kk, vv in t.items()} for k, t in table.items()}

    phase("kernels_vs_plain", tolerance=0, max_abs_err=errs,
          shapes={"elementwise": [WIDTH, n_rows],
                  "poseidon2_permute": [n_states, 12]},
          timing=rounded(timing), timing_main_vm=rounded(timing_mv),
          timing_sorters=rounded(timing_srt))

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
    for name in ("gl_mul", "poseidon2_permute", "gl_add", "gl_sub",
                 "gl_pow7"):
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

    main_proof = proof  # later phases reuse the name `proof`

    # -- 6. the other two prover paths at the golden shape --------------------
    gwit = fl.flagship_witness(gir, seed=42, device=dev)
    gir_unstrat = dataclasses.replace(gir, gate_part_degrees=None,
                                      gate_part_cols=None)
    path_s = {}
    for label, path_ir, retain in (("unstratified", gir_unstrat, False),
                                   ("retained_lde", gir, True)):
        pk.RETAIN_LDE = retain
        try:
            got, path_s[label] = timed(lambda: pk.prove(
                path_ir, gsetup, gwit, gcfg, device=dev))
        finally:
            pk.RETAIN_LDE = False
        if json.loads(json.dumps(serde.proof_to_json(got))) != golden_proof:
            raise SystemExit(f"paths: the {label} proof differs from the "
                             "golden JSON")
    del gwit
    phase("paths", shape="golden flagship (log_n 6, width 8)",
          proof_equal={k: True for k in path_s},
          seconds={k: round(v, 3) for k, v in path_s.items()})

    # -- 7. the golden MainVM instance on the card ----------------------------
    t0 = time.time()
    sgeo = mvc.VmGeometry(**golden.MAIN_VM_GEOMETRY)
    scfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    sart = wmv.compute_main_vm_artifacts(
        golden.trace_main_vm_block(), sgeo, capacity=golden.MAIN_VM_CYCLES,
        device=dev)
    sir = mvc.main_vm_ir(sgeo)
    ssetup = mvc.main_vm_setup(sir, sgeo, scfg, device=dev)
    with open(os.path.join(GOLDEN_DIR, "main_vm_log8_vk.json")) as f:
        if ssetup.vk() != [int(v) for v in json.load(f)]:
            raise SystemExit("main_vm_golden: verification key differs")
    sproof = pk.prove(sir, ssetup, mvc.main_vm_witness(
        sir, sgeo, sart.instances[0], device=dev), scfg, device=dev)
    with open(os.path.join(GOLDEN_DIR, "main_vm_log8_proof.json")) as f:
        if json.loads(json.dumps(serde.proof_to_json(sproof))) != json.load(f):
            raise SystemExit("main_vm_golden: proof differs from the golden "
                             "JSON")
    if not pk.verify(sir, ssetup.vk(), sproof, scfg, device=dev, strict=True):
        raise SystemExit("main_vm_golden: proof does not verify")
    torch.cuda.synchronize()
    phase("main_vm_golden", geometry=golden.MAIN_VM_GEOMETRY,
          cycles=golden.MAIN_VM_CYCLES, vk_equal=True, proof_equal=True,
          verify=True, seconds=round(time.time() - t0, 3))
    del sart, sir, ssetup, sproof

    # -- 8. one real MainVM instance at full size -----------------------------
    mv_cfg = pk.PlonkishConfig(rate=2, cap_size=16, num_queries=50,
                               final_fri_size=512)
    t0 = time.time()
    tracer = golden.trace_program(main_vm_block(golden, isa), 10_000)
    trace_s = time.time() - t0
    if tracer.cycle_counter != MAIN_VM_CYCLES:
        raise SystemExit(f"main_vm: the block ran {tracer.cycle_counter} "
                         f"cycles, not {MAIN_VM_CYCLES}")
    # the two halves of the decomposition once on their own, for the
    # breakdown: the host decode, and the challenge hash, which is the serial
    # sponge on the card. The path below runs both again inside
    # compute_main_vm_artifacts, and only that run is counted.
    ck.reset_launches()
    mv_rows, decode_s = timed(lambda: wmv.decode_cycle_rows(tracer))
    _, challenges_s = timed(lambda: wmv.draw_vm_challenges(mv_rows, mv_geo,
                                                           device=dev))
    challenge_launches = ck.LAUNCHES["poseidon2_permute"]
    del mv_rows
    tracing.GLOBAL.enabled = True
    tracing.GLOBAL.spans.clear()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    mv_art, artifacts_s = timed(lambda: wmv.compute_main_vm_artifacts(
        tracer, mv_geo, capacity=MAIN_VM_CYCLES, device=dev))
    if len(mv_art.instances) != 1:
        raise SystemExit("main_vm: expected one instance")
    wmv.crosscheck_query_binding(tracer, mv_geo, mv_art)
    mv_inst = mv_art.instances[0]
    mv_wit, fill_s = timed(lambda: mvc.main_vm_witness(mv_ir, mv_geo, mv_inst,
                                                       device=dev))
    mv_setup, mv_setup_s = timed(lambda: mvc.main_vm_setup(
        mv_ir, mv_geo, mv_cfg, device=dev))
    launches_before_prove = dict(ck.LAUNCHES)
    mv_proof, mv_prove_s = timed(lambda: pk.prove(mv_ir, mv_setup, mv_wit,
                                                  mv_cfg, device=dev))
    launches_one_prove = {k: ck.LAUNCHES[k] - launches_before_prove[k]
                          for k in ck.LAUNCHES}
    mv_stages = prove_stages(tracing.GLOBAL.flat_durations())
    mv_vk = mv_setup.vk()
    mv_ok, mv_verify_s = timed(lambda: pk.verify(
        mv_ir, mv_vk, mv_proof, mv_cfg, device=dev, strict=True))
    if not mv_ok:
        raise SystemExit("main_vm: proof does not verify")
    # as on the flagship path: artifacts, witness, setup, one prove, verify
    launches_mv = dict(ck.LAUNCHES)
    tracing.GLOBAL.spans.clear()
    mv_again, mv_warm_s = timed(lambda: pk.prove(mv_ir, mv_setup, mv_wit,
                                                 mv_cfg, device=dev))
    mv_stages_warm = prove_stages(tracing.GLOBAL.flat_durations())
    tracing.GLOBAL.enabled = False
    if serde.proof_to_json(mv_again) != serde.proof_to_json(mv_proof):
        raise SystemExit("main_vm: a second prove gave a different proof")
    del mv_again
    for name in ("gl_mul", "poseidon2_permute", "gl_add", "gl_sub"):
        if launches_mv[name] <= 0:
            raise SystemExit(f"main_vm path launched {name} no time")
    expected_pis = [int(v) % P for v in
                    mvc.expected_public_inputs(mv_geo, mv_inst)]
    if [int(v) for v in mv_proof.public_inputs] != expected_pis:
        raise SystemExit("main_vm: public inputs are not the expected ones")
    assert len(mv_proof.ood_witness) == mv_ir.num_witness
    assert all(0 <= v < P for pair in mv_proof.ood_witness for v in pair)
    assert mv_proof.witness_cap.shape == (mv_cfg.cap_size, 4)

    def mv_tampered(mutate):
        bad = copy.deepcopy(mv_proof)
        mutate(bad)
        return pk.verify(mv_ir, mv_vk, bad, mv_cfg, device=dev)

    def bump_exit_pc(p):  # PI 16: the pc at the last row
        p.public_inputs[16] = (p.public_inputs[16] + 1) % P

    def bump_stage3_opening(p):
        idx = sorted(p.openings["stage3"].keys())[0]
        p.openings["stage3"][idx][5] = (p.openings["stage3"][idx][5] + 1) % P

    mv_rejected = {"public_input": not mv_tampered(bump_exit_pc),
                   "ood_witness": not mv_tampered(bump_ood),
                   "stage3_opening": not mv_tampered(bump_stage3_opening)}
    if not all(mv_rejected.values()):
        raise SystemExit(f"main_vm: a tampered proof was accepted: "
                         f"{mv_rejected}")
    # the proof and its VK, for the JAX package's verifier
    # (tests/test_torch_tower13.py, `slow`), beside the --out file
    if args.out:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                               "main_vm_production")
        os.makedirs(out_dir, exist_ok=True)
        summary = dict(cycles=MAIN_VM_CYCLES,
                       geometry=dataclasses.asdict(mv_geo),
                       config=dataclasses.asdict(mv_cfg),
                       shape=[mv_ir.log_n, mv_ir.num_witness],
                       public_inputs=expected_pis)
        for name, obj in (("main_vm_production_vk.json", mv_vk),
                          ("main_vm_production_proof.json",
                           serde.proof_to_json(mv_proof)),
                          ("main_vm_production_summary.json", summary)):
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(obj, f)
    phase("main_vm", cycles=MAIN_VM_CYCLES, log_n=mv_geo.log_n,
          limb_bits=mv_geo.limb_bits, num_limbs=mv_geo.num_limbs,
          width=mv_ir.num_witness,
          gate_constraints=mv_ir.num_gate_constraints,
          lookup_sets=len(mv_ir.lookup_sets),
          public_inputs=len(expected_pis),
          config={"rate": mv_cfg.rate, "cap_size": mv_cfg.cap_size,
                  "num_queries": mv_cfg.num_queries,
                  "final_fri_size": mv_cfg.final_fri_size},
          trace_s=round(trace_s, 3), decode_rows_s=round(decode_s, 3),
          draw_vm_challenges_s=round(challenges_s, 3),
          draw_vm_challenges_permutations=challenge_launches,
          artifacts_s=round(artifacts_s, 3),
          witness_fill_s=round(fill_s, 3), setup_s=round(mv_setup_s, 3),
          prove_s=round(mv_prove_s, 3), prove_warm_s=round(mv_warm_s, 3),
          cycles_per_s=round(MAIN_VM_CYCLES / mv_warm_s, 1),
          verify_s=round(mv_verify_s, 3), verify=True,
          public_inputs_as_expected=True, second_proof_equal=True,
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          tampered_rejected=mv_rejected, launches=launches_mv,
          launches_one_prove=launches_one_prove, stages_s=mv_stages,
          stages_warm_s=mv_stages_warm)

    # -- 9. the golden block's memory and log circuits on the card ------------
    # the 200-cycle golden block: its first instance of each circuit at the
    # capacities of golden.SORTER_CAPACITY, through the typed layer functions
    t0 = time.time()
    gtracer = golden.trace_main_vm_block()
    cap = golden.SORTER_CAPACITY

    def block_streams(tr):
        demuxed = oracle.demux_log_queue(tr.final_log_queue())
        return {"memory": [q for _, q in tr.memory_queries],
                "log": [q for _, q in tr.final_log_queue()],
                "events": [q for _, q in demuxed["events"]],
                "storage": [q for _, q in demuxed["storage"]]}

    def sorter_circuits(streams, caps):
        """(name, circuit type, setup, decompose, prove, verify, expected
        public inputs) of the four circuits: setup() gives (setup data,
        geometry), decompose() (instances, challenges)."""
        def ram_art():
            a = compute_ram_circuit_snapshots(streams["memory"], caps["ram"],
                                              device=dev)
            return a.instances, a.challenges

        def events_art():
            a = compute_events_circuit_artifacts(
                streams["events"], caps["events"], circuit_type=11,
                device=dev)
            return a.instances, a.challenges

        def storage_art():
            a = compute_storage_circuit_artifacts(
                streams["storage"], caps["storage"], device=dev)
            return a.instances, a.challenges

        def demux_art():
            a = compute_log_demux_artifacts(streams["log"], caps["demux"],
                                            device=dev)
            return a.instances, None

        return [
            ("ram", 8, lambda: ly.ram_setup_data(caps["ram"], device=dev),
             ram_art,
             lambda i, c: ly.prove_ram_instance(i, c, caps["ram"],
                                                device=dev),
             lambda i, c, p: ly.verify_ram_instance(i, c, caps["ram"], p,
                                                    device=dev),
             rcirc.instance_public_inputs),
            ("events", 11,
             lambda: ly.events_setup_data(caps["events"], device=dev),
             events_art,
             lambda i, c: ly.prove_events_instance(i, c, caps["events"],
                                                   device=dev),
             lambda i, c, p: ly.verify_events_instance(
                 i, c, caps["events"], p, device=dev),
             ecirc.instance_public_inputs),
            ("storage", 9,
             lambda: ly.storage_setup_data(caps["storage"], device=dev),
             storage_art,
             lambda i, c: ly.prove_storage_instance(i, c, caps["storage"],
                                                    device=dev),
             lambda i, c, p: ly.verify_storage_instance(
                 i, c, caps["storage"], p, device=dev),
             sscirc.instance_public_inputs),
            ("demux", 4,
             lambda: ly.demux_setup_data(caps["demux"], device=dev),
             demux_art,
             lambda i, c: ly.prove_demux_instance(i, caps["demux"],
                                                  device=dev),
             lambda i, c, p: ly.verify_demux_instance(i, caps["demux"], p,
                                                      device=dev),
             lambda geo, i, c: dcirc.instance_public_inputs(geo, i))]

    golden_s = {}
    with ly.engine_override(scfg):
        for name, _ct, setup_of, decompose, prove_one, verify_one, _pi in \
                sorter_circuits(block_streams(gtracer), cap):
            t1 = time.time()
            insts, chals = decompose()
            gp = prove_one(insts[0], chals)
            with open(os.path.join(GOLDEN_DIR, f"{name}_log8_vk.json")) as f:
                if setup_of()[0].vk != [int(v) for v in json.load(f)]:
                    raise SystemExit(f"sorters_golden: {name} verification "
                                     "key differs")
            with open(os.path.join(GOLDEN_DIR,
                                   f"{name}_log8_proof.json")) as f:
                if json.loads(json.dumps(serde.proof_to_json(gp))) != \
                        json.load(f):
                    raise SystemExit(f"sorters_golden: {name} proof differs "
                                     "from the golden JSON")
            if not verify_one(insts[0], chals, gp):
                raise SystemExit(f"sorters_golden: {name} proof does not "
                                 "verify")
            torch.cuda.synchronize()
            golden_s[name] = round(time.time() - t1, 3)
    ly._SETUP_CACHE.clear()
    phase("sorters_golden", capacities=cap, vk_equal=True, proof_equal=True,
          verify=True, seconds=golden_s,
          total_s=round(time.time() - t0, 3))

    # -- 10. the block's memory and log subsystem at production geometry -----
    geo_cfg = GeometryConfig()
    prod_caps = {"ram": geo_cfg.cycles_per_ram_permutation,
                 "events": geo_cfg.cycles_per_events_or_l1_messages_sorter,
                 "storage": geo_cfg.cycles_per_storage_sorter,
                 "demux": geo_cfg.cycles_per_log_demuxer}
    streams = block_streams(tracer)  # the 5585-cycle block of phase 8
    per_type = {}
    tracing.GLOBAL.enabled = True
    ck.reset_launches()
    t_path = time.time()
    with ly.engine_override(mv_cfg):
        for name, ctype, setup_of, decompose, _prove, _verify, \
                _pis in sorter_circuits(streams, prod_caps):
            torch.cuda.empty_cache()
            (insts, _chals), art_s = timed(decompose)
            if len(insts) != 1:
                raise SystemExit(f"sorters: {name}: expected one instance, "
                                 f"got {len(insts)}")
            inst = insts[0]
            if ctype == 4:
                # the log demuxer's setup (9,894 x 2^16, the largest) is
                # made, and its VK compared, under its leaf in `tower13`
                per_type[name] = {"circuit_type": ctype, "items": int(
                    getattr(inst, "num_items", 0)),
                    "artifacts_s": round(art_s, 3), "proved": False,
                    "vk_equal_in": "tower13"}
                continue
            (sd, geo), setup_s = timed(setup_of)
            vks = {ctype: sd.vk}
            if ctype == 11:  # the L1-messages sorter shares the gate set
                vks[12] = ly.events_setup_data(prod_caps["events"],
                                               circuit_type=12,
                                               device=dev)[0].vk
            for t, vk in vks.items():
                with open(os.path.join(PROD_VK_DIR, f"vk_{t}.json")) as f:
                    if vk != [int(v) for v in json.load(f)]:
                        raise SystemExit(f"sorters: the production VK of "
                                         f"type {t} differs from "
                                         f"setup/setup/base_layer/vk_{t}.json")
            # decomposed and its VK compared only: phase `tower13` proves
            # the RAM permutation, the events and storage sorters and the log
            # demuxer (8, 11, 9, 4) over the whole block, at the same
            # geometry and VK
            per_type[name] = {
                "circuit_type": ctype, "log_n": sd.ir.log_n,
                "width": sd.ir.num_witness, "vk_equal": sorted(vks),
                "items": int(getattr(inst, "num_items", 0)),
                "artifacts_s": round(art_s, 3),
                "setup_s": round(setup_s, 3), "proved": False}
            del sd, geo
            ly._SETUP_CACHE.clear()
    launches_srt = dict(ck.LAUNCHES)
    path_s = time.time() - t_path
    tracing.GLOBAL.enabled = False
    for name in ("gl_mul", "poseidon2_permute"):
        if launches_srt[name] <= 0:
            raise SystemExit(f"sorters path launched {name} no time")
    torch.cuda.empty_cache()
    phase("sorters", capacities=prod_caps,
          config={"rate": mv_cfg.rate, "cap_size": mv_cfg.cap_size,
                  "num_queries": mv_cfg.num_queries,
                  "final_fri_size": mv_cfg.final_fri_size},
          streams={k: len(v) for k, v in streams.items()},
          path_s=round(path_s, 3), launches=launches_srt, types=per_type)

    # -- 11. the golden hash block's hash circuits on the card ---------------
    # the small hash block (golden.HASH_GOLDEN): the first instance of each
    # hash circuit at the capacities of golden.HASH_CAPACITY
    def hash_streams(tr):
        calls = {a: [d for (_, q, d, _r) in tr.precompile_calls
                     if q.address == a]
                 for a in (golden.KECCAK_ADDRESS, golden.SHA256_ADDRESS)}
        demuxed = oracle.demux_log_queue(tr.final_log_queue())
        return {"keccak": calls[golden.KECCAK_ADDRESS],
                "sha256": calls[golden.SHA256_ADDRESS],
                "l1": [q for _, q in demuxed["l1"]],
                "decommits": [q for _, q in tr.decommittment_queries],
                "bytecodes": tr.decommitted_bytecodes}

    def hash_circuits(st, caps):
        """(name, circuit type, setup, decompose, prove, verify, expected
        public inputs) of the five hash circuits: setup() gives (setup data,
        geometry), decompose() (instances, context, artifacts)."""
        def keccak_art():
            a = compute_keccak_circuit_artifacts(st["keccak"], caps["keccak"],
                                                 device=dev)
            return a.instances, (a.challenges, a.gammas), a

        def sha256_art():
            a = compute_sha256_circuit_artifacts(st["sha256"], caps["sha256"],
                                                 device=dev)
            return a.instances, (a.challenges, a.gammas), a

        def hasher_art():
            a = compute_hasher_circuit_artifacts(
                oracle.dedup_events(st["l1"]), caps["hasher"], device=dev)
            return a.instances, None, a

        def decommitter_art():
            a = compute_code_decommitter_artifacts(
                [q for q in st["decommits"] if q.is_fresh], st["bytecodes"],
                device=dev)
            return a.instances, None, a

        def decommitts_art():
            a = compute_decommitts_circuit_artifacts(
                st["decommits"], caps["decommitts"], device=dev)
            return a.instances, a.challenges, a

        c = caps
        return [
            ("keccak", 5, lambda: ly.keccak_setup_data(c["keccak"],
                                                       device=dev),
             keccak_art,
             lambda i, x: ly.prove_keccak_instance(i, x, c["keccak"],
                                                   device=dev),
             lambda i, x, p: ly.verify_keccak_instance(i, x, c["keccak"], p,
                                                       device=dev),
             kcirc.instance_public_inputs),
            ("sha256", 6, lambda: ly.sha256_setup_data(c["sha256"],
                                                       device=dev),
             sha256_art,
             lambda i, x: ly.prove_sha256_instance(i, x, c["sha256"],
                                                   device=dev),
             lambda i, x, p: ly.verify_sha256_instance(i, x, c["sha256"], p,
                                                       device=dev),
             shcirc.instance_public_inputs),
            ("hasher", 13, lambda: ly.hasher_setup_data(c["hasher"],
                                                        device=dev),
             hasher_art,
             lambda i, x: ly.prove_hasher_instance(i, c["hasher"],
                                                   device=dev),
             lambda i, x, p: ly.verify_hasher_instance(i, c["hasher"], p,
                                                       device=dev),
             lambda geo, i, x: lhcirc.expected_public_inputs(geo, i)),
            ("decommitter", 3,
             lambda: ly.code_decommitter_setup_data(c["decommitter"],
                                                    device=dev),
             decommitter_art,
             lambda i, x: ly.prove_code_decommitter_instance(
                 i, c["decommitter"], device=dev),
             lambda i, x, p: ly.verify_code_decommitter_instance(
                 i, c["decommitter"], p, device=dev),
             lambda geo, i, x: cdcirc.expected_public_inputs(geo, i)),
            ("decommitts", 2,
             lambda: ly.decommitts_setup_data(c["decommitts"], device=dev),
             decommitts_art,
             lambda i, x: ly.prove_decommitts_instance(i, x, c["decommitts"],
                                                       device=dev),
             lambda i, x, p: ly.verify_decommitts_instance(
                 i, x, c["decommitts"], p, device=dev),
             dscirc.instance_public_inputs)]

    t0 = time.time()
    hcap = golden.HASH_CAPACITY
    golden_s = {}
    with ly.engine_override(scfg):
        for name, _ct, setup_of, decompose, prove_one, verify_one, _pi in \
                hash_circuits(hash_streams(golden.trace_hash_block(
                    **golden.HASH_GOLDEN)), hcap):
            t1 = time.time()
            insts, ctx, _art = decompose()
            gp = prove_one(insts[0], ctx)
            gsd, ggeo = setup_of()
            stem = os.path.join(GOLDEN_DIR, f"{name}_log{ggeo.log_n}")
            with open(stem + "_vk.json") as f:
                if gsd.vk != [int(v) for v in json.load(f)]:
                    raise SystemExit(f"hashes_golden: {name} verification "
                                     "key differs")
            with open(stem + "_proof.json") as f:
                if json.loads(json.dumps(serde.proof_to_json(gp))) != \
                        json.load(f):
                    raise SystemExit(f"hashes_golden: {name} proof differs "
                                     "from the golden JSON")
            if not verify_one(insts[0], ctx, gp):
                raise SystemExit(f"hashes_golden: {name} proof does not "
                                 "verify")
            torch.cuda.synchronize()
            golden_s[name] = round(time.time() - t1, 3)
    ly._SETUP_CACHE.clear()
    phase("hashes_golden", block=golden.HASH_GOLDEN, capacities=hcap,
          vk_equal=True, proof_equal=True, verify=True, seconds=golden_s,
          total_s=round(time.time() - t0, 3))

    # -- 12. the hash block's hash circuits at production geometry ------------
    # the block that far-calls and calls the precompiles (golden.HASH_BLOCK,
    # 293 rounds); every instance of types 5, 6, 13, 3 and 2 at the
    # GeometryConfig() capacities, then the same block's MainVM (type 1) and
    # L1-messages sorter (type 12) instances
    hprod_caps = {"keccak": geo_cfg.cycles_per_keccak256_circuit,
                  "sha256": geo_cfg.cycles_per_sha256_circuit,
                  "hasher": geo_cfg.limit_for_l1_messages_pudata_hasher,
                  "decommitter": geo_cfg.cycles_per_code_decommitter,
                  "decommitts": geo_cfg.cycles_per_code_decommitter_sorter}
    htracer, htrace_s = timed(lambda: golden.trace_hash_block(
        **golden.HASH_BLOCK))
    hst = hash_streams(htracer)
    fresh = [q for q in hst["decommits"] if q.is_fresh]
    hblock = {"cycles": htracer.cycle_counter,
              "keccak_calls": len(hst["keccak"]),
              "sha256_calls": len(hst["sha256"]),
              "decommitment_queries": len(hst["decommits"]),
              "fresh_decommitments": len(fresh),
              "l1_messages": len(hst["l1"]),
              "memory_queries": len(htracer.memory_queries)}
    if (hblock["cycles"], hblock["keccak_calls"], hblock["sha256_calls"],
            hblock["decommitment_queries"], hblock["fresh_decommitments"],
            hblock["l1_messages"]) != (1520, 293, 293, 37, 4, 384):
        raise SystemExit(f"hashes: the hash block is not the expected one: "
                         f"{hblock}")
    serialized = b"".join(serialize_l1_message(q)
                          for q in oracle.dedup_events(hst["l1"]))
    hper_type = {}
    tracing.GLOBAL.enabled = True
    ck.reset_launches()
    t_path = time.time()

    def vk_digest(vk):
        return hashlib.sha256(",".join(str(int(v)) for v in vk)
                              .encode()).hexdigest()

    def check_instance(name, sd, geo, inst, ctx, proof, verify_one, pis_of):
        """Public inputs as expected, shapes, tampered copies refused."""
        expected = [int(v) % P for v in pis_of(geo, inst, ctx)]
        if [int(v) for v in proof.public_inputs] != expected:
            raise SystemExit(f"hashes: {name}: public inputs are not the "
                             "expected ones")
        assert len(proof.ood_witness) == sd.ir.num_witness
        assert all(0 <= v < P for pair in proof.ood_witness for v in pair)
        assert proof.witness_cap.shape == (mv_cfg.cap_size, 4)
        bad_pi, bad_ood = copy.deepcopy(proof), copy.deepcopy(proof)
        bump_pi(bad_pi)
        bump_ood(bad_ood)
        tamper = {"public_input": not verify_one(inst, ctx, bad_pi)
                  and not pk.verify(sd.ir, sd.vk, bad_pi, sd.config,
                                    device=dev),
                  "ood_witness": not verify_one(inst, ctx, bad_ood)}
        if not all(tamper.values()):
            raise SystemExit(f"hashes: {name}: a tampered proof was "
                             f"accepted: {tamper}")
        return expected, tamper

    def prove_checked(k, inst, name, sd, geo, ctx, rec, proves, verifies,
                      fills, prove_one, verify_one, pis_of):
        """Prove and verify one instance (the first: stages, launches,
        tampered copies); its public inputs."""
        tracing.GLOBAL.spans.clear()
        before_prove = dict(ck.LAUNCHES)
        proof, prove_s = timed(lambda: prove_one(inst, ctx))
        if k == 0:
            rec["launches_one_prove"] = {
                kk: ck.LAUNCHES[kk] - before_prove[kk] for kk in ck.LAUNCHES}
            rec["stages_s"] = prove_stages(tracing.GLOBAL.flat_durations())
        fills.append(round(tracing.GLOBAL.flat_durations().get(
            "layers.witness", 0.0), 3))
        ok, verify_s = timed(lambda: verify_one(inst, ctx, proof))
        if not ok:
            raise SystemExit(f"hashes: {name} instance {k} does not verify")
        proves.append(round(prove_s, 3))
        verifies.append(round(verify_s, 3))
        if k == 0:
            if args.profile:  # as in phase `sorters`
                counted = dict(ck.LAUNCHES)
                _, warm_s = timed(lambda: prove_one(inst, ctx))
                _, rows = device_rows(lambda: prove_one(inst, ctx),
                                      host_too=False)
                ck.LAUNCHES.update(counted)
                busy_s = sum(r[2] for r in rows) / 1e6
                rec["prove_warm_s"] = round(warm_s, 3)
                rec["device_busy_s"] = round(busy_s, 3)
                rec["device_idle_share"] = round(1 - busy_s / warm_s, 3)
            expected, tamper = check_instance(
                name, sd, geo, inst, ctx, proof, verify_one, pis_of)
            rec["public_inputs"] = len(expected)
            rec["tampered_rejected"] = tamper
        return [int(v) for v in proof.public_inputs]

    with ly.engine_override(mv_cfg):
        for name, ctype, setup_of, decompose, prove_one, verify_one, \
                pis_of in hash_circuits(hst, hprod_caps):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(ck.LAUNCHES)
            (insts, ctx, art), art_s = timed(decompose)
            want_n = {"decommitter": len(fresh)}.get(name, 1)
            if len(insts) != want_n:
                raise SystemExit(f"hashes: {name}: expected {want_n} "
                                 f"instances, got {len(insts)}")
            (sd, geo), setup_s = timed(setup_of)
            rec = {"circuit_type": ctype, "log_n": sd.ir.log_n,
                   "width": sd.ir.num_witness, "const_cols": sd.ir.num_const,
                   "gate_constraints": sd.ir.num_gate_constraints,
                   "gate_degree": sd.ir.gate_degree,
                   "lookup_sets": len(sd.ir.lookup_sets),
                   "instances": len(insts), "vk_sha256": vk_digest(sd.vk)}
            # type 5's from tools/gen_cli_golden.py, the others under setup/
            vk_path = (os.path.join(GOLDEN_DIR, "vk_5_production.json")
                       if ctype == 5 else
                       os.path.join(PROD_VK_DIR, f"vk_{ctype}.json"))
            with open(vk_path) as f:
                if sd.vk != [int(v) for v in json.load(f)]:
                    raise SystemExit(
                        f"hashes: the production VK of type {ctype} "
                        f"differs from {os.path.relpath(vk_path, REPO_DIR)}")
            rec["vk_equal"] = True
            proves, verifies, fills = [], [], []
            # the first of the four code-decommitter instances only (the
            # same circuit, 12 s of the script): all four are decomposed
            # and counted above. The decommitments sorter, the code
            # decommitter and the hasher (2, 3, 13) are proved at this
            # geometry in phase `tower13` over the whole block: here their
            # digests are checked on the expected public inputs
            checked = insts[:1] if name == "decommitter" else insts
            proved = checked if ctype in HASHES_PROVED else []
            rec["instances_proved"] = len(proved)
            for k, inst in enumerate(checked):
                if proved:
                    pis = prove_checked(k, inst, name, sd, geo, ctx, rec,
                                        proves, verifies, fills, prove_one,
                                        verify_one, pis_of)
                else:
                    pis = [int(v) % P for v in pis_of(geo, inst, ctx)]
                if name in ("keccak", "sha256"):
                    if pis[-5:-3] != [int(x) for x in art.final_accs] or \
                            pis[-1] != art.total_invocations:
                        raise SystemExit(f"hashes: {name}: final "
                                         "accumulators are not in the last "
                                         "PI lanes")
                    rec["invocations"] = art.total_invocations
                    rec["slots"] = geo.capacity
                elif name == "hasher":
                    if lhcirc.digest_bytes(pis) != keccak256(serialized) \
                            or art.digest != keccak256(serialized):
                        raise SystemExit("hashes: the hasher's digest is not "
                                         "keccak256 of the L1 messages")
                    rec["digest_is_keccak256"] = True
                    rec["blocks"] = len(inst.blocks)
                    rec["slots"] = geo.capacity
                elif name == "decommitter":
                    words = hst["bytecodes"][art.hashes[k]]
                    sha = hashlib.sha256(b"".join(
                        int(w).to_bytes(32, "big") for w in words)).digest()
                    if cdcirc.digest_bytes(pis) != sha or \
                            sha[4:] != art.hashes[k].to_bytes(32, "big")[4:]:
                        raise SystemExit(f"hashes: decommitter instance {k}: "
                                         "digest is not the SHA-256 inside "
                                         "the versioned hash")
                    rec["digest_in_versioned_hash"] = True
                    rec.setdefault("blocks", []).append(len(inst.blocks))
                    rec["slots"] = geo.capacity
                else:
                    rec["requests"] = int(inst.num_items)
                    rec["fresh"] = int(inst.out_items)
            rec.update({
                "artifacts_s": round(art_s, 3), "setup_s": round(setup_s, 3),
                "witness_fill_s": fills, "prove_s": proves,
                "verify_s": verifies, "verify": bool(proved),
                "public_inputs_as_expected": bool(proved),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": {k: ck.LAUNCHES[k] - before[k]
                             for k in ck.LAUNCHES}})
            hper_type[name] = rec
            del sd, geo
            ly._SETUP_CACHE.clear()

    launches_hash = dict(ck.LAUNCHES)
    hpath_s = time.time() - t_path
    tracing.GLOBAL.enabled = False
    for name in ("gl_mul", "poseidon2_permute"):
        if launches_hash[name] <= 0:
            raise SystemExit(f"hashes path launched {name} no time")
    torch.cuda.empty_cache()
    phase("hashes", block=golden.HASH_BLOCK, stream_counts=hblock,
          trace_s=round(htrace_s, 3), capacities=hprod_caps,
          config={"rate": mv_cfg.rate, "cap_size": mv_cfg.cap_size,
                  "num_queries": mv_cfg.num_queries,
                  "final_fri_size": mv_cfg.final_fri_size},
          path_s=round(hpath_s, 3), launches=launches_hash, types=hper_type)

    # K1 and K2 at the hash path's most-launched shapes
    # (tools/count_hash_launches.py): one coset row of the keccak / hasher
    # (2^14) and SHA-256 (2^18) traces for the multiply; the lone state of
    # the transcripts and challenge sponges, and the 2^15 leaves of the
    # keccak / hasher commitments, for the permutation
    timing_hash = {}
    for label, shape in (("gl_mul", (1 << 14,)),
                         ("gl_mul_sha256", (1 << 18,))):
        ta, tb = rand_field(shape), rand_field(shape)
        errs["gl_mul"] = max(errs["gl_mul"], check_equal(
            "gl_mul hashes shape", ck.gl_mul(ta, tb),
            ck.gl_mul_plain(ta, tb)))
        timing_hash[label] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: ck.gl_mul(ta, tb), 10, 200),
            "plain_ms": cuda_ms(lambda: ck.gl_mul_plain(ta, tb), 1, 3),
            "bytes": 3 * 8 * ta.numel(), "ops": ta.numel() * OPS_MUL}
        del ta, tb
    for label, states in (("poseidon2_permute", 1 << 15),
                          ("poseidon2_permute_one_state", 1)):
        ts = rand_field((states, 12))
        errs["poseidon2_permute"] = max(errs["poseidon2_permute"],
                                        check_equal(
            "poseidon2 hashes shape", ck.poseidon2_permute(ts),
            ck.poseidon2_permute_plain(ts)))
        reps = (10, 200) if states == 1 else (5, 50)
        timing_hash[label] = {
            "shape": [states, 12],
            "ms": cuda_ms(lambda: ck.poseidon2_permute(ts), *reps),
            "plain_ms": cuda_ms(lambda: ck.poseidon2_permute_plain(ts), 1, 2),
            "bytes": 2 * 8 * 12 * states,
            "ops": states * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD)}
        del ts
    for t in timing_hash.values():
        by = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        op = t["ops"] / PEAK_INT_ALU_PER_S * 1e3
        t["bound_ms"] = max(by, op)
        t["bound_by"] = "bytes" if by >= op else "operations"
    phase("kernels_hashes", tolerance=0,
          max_abs_err={k: errs[k] for k in ("gl_mul", "poseidon2_permute")},
          timing=rounded(timing_hash))

    # -- 14-16. the whole block: types 7 and 10, all 13 base types -----------
    launches_block, timing_block = block_phases(
        args, dev, phase, rand_field, check_equal, cuda_ms, errs)

    # -- 17-22. the tower and the wrap: golden, full chain, blob, kernels ----
    tower_paths, timing_tower, timing_wrap, timing_fw, timing_t13 = \
        tower_phases(args, dev, phase, rand_field, check_equal, cuda_ms,
                     errs)

    # -- 17-19b. the golden towers, in two processes of their own beside ----
    # the phases up to the mesh's (they time nothing, and those time no
    # kernel of the kernels line)
    ly._SETUP_CACHE.clear()
    torch.cuda.empty_cache()
    with _worker_allocator():
        golden_pool = multiprocessing.get_context("spawn").Pool(
            len(BACKGROUND_GOLDENS))
    try:
        background = {name: golden_pool.apply_async(_background_golden,
                                                    (name,))
                      for name in BACKGROUND_GOLDENS}

        # -- 24-29. the CLI, the AIR STARK engine, the gadgets, the ---------
        # reference dialect of the main path's proof
        with tempfile.TemporaryDirectory() as tmp:
            launches_cli_golden, launches_cli = cli_phases(args, phase, tmp)
        launches_stark = stark_phases(dev, phase)
        gadgets_golden_phase(dev, phase)
        ref_serde_phase(dev, phase, ir, setup, main_proof, cfg)

        # -- 29-31. proving across cards: the sharded prove, the -----------
        # distributed NTT
        launches_mesh = mesh_phases(args, dev, phase, ir, setup.vk(), cfg,
                                    main_proof)
        for name, job in background.items():
            recs, out, stopped = job.get()
            for rec in recs:
                phase(rec.pop("phase"), background=True, **rec)
            if stopped is not None:
                raise SystemExit(stopped)
            if name == "golden_tower":
                tower_paths["fw_golden"] = out
        golden_pool.close()
    finally:
        golden_pool.terminate()
        golden_pool.join()
    new_paths = {"cli_golden": launches_cli_golden, "cli": launches_cli,
                 "stark": launches_stark, "mesh": launches_mesh}

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
        wall_s, rows = device_rows(
            lambda: pk.prove(mv_ir, mv_setup, mv_wit, mv_cfg, device=dev),
            host_too=False)
        busy_s = sum(r[2] for r in rows) / 1e6
        top = sorted(rows, key=lambda r: -r[2])[:12]
        phase("profile_main_vm", profiled_wall_s=round(wall_s, 3),
              prove_warm_s=round(mv_warm_s, 3),
              device_busy_s=round(busy_s, 3),
              device_idle_share=round(1 - busy_s / mv_warm_s, 3),
              device_launches=sum(r[1] for r in rows),
              top_kernels=[{"name": k[:80], "count": c,
                            "device_ms": round(us / 1e3, 2)}
                           for k, c, us in top])

    # -- optional: broadcasts addressed in the kernel against materialised ----
    if args.compare_broadcast:
        witness = fl.flagship_witness(ir, seed=0, device=dev)
        want = serde.proof_to_json(main_proof)
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
        # launches: every path together, each counted from 0 and
        # read just after its run; ms and the bound at the flagship's shape,
        # the MainVM and sorters paths' beside them
        t = timing[name]
        by_path = {"flagship": launches[name], "main_vm": launches_mv[name],
                   "sorters": launches_srt[name],
                   "hashes": launches_hash[name],
                   "block": launches_block[name],
                   **{p: tower_paths[p][name] for p in tower_paths},
                   **{p: c.get(name, 0) for p, c in new_paths.items()}}
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": errs[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": None}
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by")
        if name in timing_mv:
            out["main_vm"] = {k: timing_mv[name][k] for k in keys}
        if name in timing_srt:
            out["sorters"] = {k: timing_srt[name][k] for k in keys}
        hash_keys = [k for k in timing_hash if k.startswith(name)]
        if hash_keys:
            out["hashes"] = {h: {k: timing_hash[h][k] for k in keys}
                             for h in hash_keys}
        block_keys = [k for k in timing_block if k.startswith(name)]
        if block_keys:
            out["block"] = {b: {k: timing_block[b][k] for k in keys}
                            for b in block_keys}
        tower_keys = [k for k in timing_tower if k.startswith(name)]
        if tower_keys:
            out["tower"] = {b: {k: timing_tower[b][k] for k in keys}
                            for b in tower_keys}
        t13_keys = [k for k in timing_t13 if k.startswith(name)]
        if t13_keys:
            out["tower13"] = {b: {k: timing_t13[b][k] for k in keys}
                              for b in t13_keys}
        wrap_keys = [k for k in timing_wrap if k.startswith(name)]
        if wrap_keys:
            out["wrap"] = {b: {k: timing_wrap[b][k] for k in keys}
                           for b in wrap_keys}
        if name + "_one_state" in timing_mv:
            out["one_state"] = {k: timing_mv[name + "_one_state"][k]
                                for k in keys}
        return out

    def fw_entry(name, replaces):
        # K3: no TPU counterpart (`replaces` names the JAX package's host
        # Python it takes over); ms and the bound at the production
        # for-wrapper tree's shape, the plain version's time at the check
        # shape (exact Python ints)
        t = timing_fw[name]
        by_path = {**{p: tower_paths[p][name] for p in tower_paths},
                   **{p: c.get(name, 0) for p, c in new_paths.items()}}
        return {"name": name, "route": "cuda",
                "source": "zkevm_harness_tpu_torch/csrc/poseidon2_bn254.cu",
                "replaces": replaces, "tpu_kernel": None,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "shape": t["shape"], "plain_shape": t["plain_shape"],
                "check_ms": t["check_ms"]}

    gsrc = "zkevm_harness_tpu_torch/csrc/goldilocks.cu"
    kernels_line = {
        "kernels": [
            entry("gl_mul", gsrc,
                  "zkevm_harness_tpu/ops/pallas_kernels.py:386"),
            entry("poseidon2_permute",
                  "zkevm_harness_tpu_torch/csrc/poseidon2.cu",
                  "zkevm_harness_tpu/ops/pallas_kernels.py:255"),
            # the port's kernel with no TPU counterpart
            fw_entry("bn254_hash_rows",
                     "zkevm_harness_tpu/prover/hash_backend.py:113"),
            fw_entry("bn254_hash_pairs",
                     "zkevm_harness_tpu/prover/hash_backend.py:117")],
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
