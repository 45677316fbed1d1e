"""Per-kernel times on the card beside the least time the work allows.

The CLI's `bench-kernels` (`python -m zkevm_harness_tpu_torch
bench-kernels`): K1 (`gl_mul`), K2 (`poseidon2_permute`) and K3
(`bn254_hash_rows`, `bn254_hash_pairs`) at the shapes of the port's main
paths, each first held against its plain version, then timed with CUDA
events. One JSON line per kernel: ms per launch, the bound and what sets
it, the share of the bound the kernel reaches, the shape, and the card's
name and power limit as `nvidia-smi` reports them.

The bound of a function is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and the operations it does over the card's peak rate for their type.
The constants below are the H100's; `chip_smoke.py` reads them from here.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List

import numpy as np
import torch

# Published peaks of one H100 SXM used for the bounds: 3.35 TB/s of device
# memory, and 67 TFLOP/s of float32, which is 132 SMs x 128 lanes x 2 (a
# multiply-add counts twice) x the boost clock. An SM has 64 INT32 lanes, half
# as many, and they do one add, compare or select a clock each: a quarter of
# that figure in integer instructions a second. The same figure stands for
# the SM's 64 lanes of 32-bit integer multiplies a clock (IMAD; an IMAD.WIDE,
# a low and a high half, is two), the rate that bounds the BN254 kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_ALU_PER_S = 67e12 / 4
# Integer-ALU instructions per field operation, counted in the SASS that
# `chip_smoke.py --sass` writes (built for sm_90a): a multiply is 7 IADD3, 6
# ISETP, 6 SEL and 1 VIADD, beside 9 IMADs that run on the float32 lanes and
# so are not the tighter count; an add is 2 IADD3, 4 ISETP and 2 SEL beside 2
# IMADs.
OPS_MUL = 20
OPS_ADD = 8
# per Poseidon2 state: 8*12*4 + 22*(4+12) multiplies; adds of 9 external
# layers (62 each), 96 + 22 round constants, 22 internal sums (23 each)
P2_MULS = 8 * 12 * 4 + 22 * (4 + 12)
P2_ADDS = 9 * 62 + 96 + 22 + 22 * 23
# The work of Poseidon2 over BN254 Fr, in 32-bit multiply instructions (the
# operations the algorithm needs, whatever the kernel's own SASS does). At 8
# limbs a Montgomery multiply forms 8^2 full 32 x 32 -> 64-bit products for
# a * b and 8^2 for m * p (a low and a high half each) and 8 low halves for
# the factors m; a squaring forms each of its 28 off-diagonal products once
# and its 8 squares, then the same reduction, 8 x (2 x 8 + 1); taking a
# value out of Montgomery form is that reduction alone.
BN254_LIMBS = 8
BN254_REDC_INSNS = BN254_LIMBS * (2 * BN254_LIMBS + 1)             # 136
BN254_MUL_INSNS = 4 * BN254_LIMBS ** 2 + BN254_LIMBS               # 264
BN254_SQR_INSNS = (BN254_LIMBS * (BN254_LIMBS - 1) + 2 * BN254_LIMBS
                   + BN254_REDC_INSNS)                             # 208

# the shapes timed: the flagship's trace (130 x 2^19), the 2^20 leaves of
# its rate-2 commitment, and the production for-wrapper tree (72 x 2^18
# leaves, 2^17 pairs of its first level)
FLAGSHIP_SHAPE = (130, 1 << 19)
P2_STATES = 1 << 20
FW_WIDTH, FW_LEAVES = 72, 1 << 18


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def bound(bytes_moved: float, ops_ms: float = None, ops: float = None):
    """(bound ms, what sets it) for `bytes_moved` bytes and either `ops`
    integer instructions or an operations time `ops_ms` already computed."""
    by = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op = ops_ms if ops_ms is not None else ops / PEAK_INT_ALU_PER_S * 1e3
    return max(by, op), ("bytes" if by >= op else "operations")


def bn254_permutation_insns(params) -> int:
    """Multiply instructions of one Poseidon2-BN254 permutation, from the
    parameters' t, R_F, R_P and alpha: t S-boxes a full round and one a
    partial round, each x^alpha by squarings and multiplies (x^5 = x *
    (x^2)^2: two and one), and t multiplies by the internal diagonal, whose
    entries are full-size constants, a partial round. 98,752 at t = 3,
    R_F = 8, R_P = 56, alpha = 5."""
    t, r_f, r_p, alpha = (params[k] for k in ("t", "r_f", "r_p", "alpha"))
    sqrs = alpha.bit_length() - 1
    muls = bin(alpha).count("1") - 1
    sboxes = r_f * t + r_p
    return (sboxes * (sqrs * BN254_SQR_INSNS + muls * BN254_MUL_INSNS)
            + r_p * t * BN254_MUL_INSNS)


def bn254_bound_ms(params, perms, to_mont, from_mont) -> float:
    """The least time of `perms` permutations with `to_mont` values taken
    into Montgomery form (a multiply each) and `from_mont` out of it (a
    reduction each), at the card's integer multiply rate."""
    insns = (perms * bn254_permutation_insns(params)
             + to_mont * BN254_MUL_INSNS + from_mont * BN254_REDC_INSNS)
    return insns / PEAK_INT_ALU_PER_S * 1e3


def cuda_ms(fn, warm: int, reps: int) -> float:
    """Milliseconds per call of `fn` by CUDA events, after `warm` calls."""
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


def bench_kernels(device=None, seed: int = 0) -> List[Dict]:
    """Hold each kernel against its plain version (at a small shape for K3,
    whose plain version is exact Python ints), then time it at its main
    path's shape. Returns one record per kernel."""
    from ..ops import cuda_kernels as ck
    from ..ops import goldilocks as gl
    from ..utils import poseidon2_bn254 as p2b

    dev = gl.resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench-kernels times the kernels on a CUDA card")
    rng = np.random.default_rng(seed)
    smi = nvidia_smi_line()

    def rand_field(shape):
        return gl.from_u64(rng.integers(0, gl.P, size=shape,
                                        dtype=np.uint64), dev)

    def fr_limbs(k):
        words = rng.integers(0, 1 << 63, size=(k, 4), dtype=np.int64)
        vals = [sum(int(w) << (63 * j) for j, w in enumerate(ws)) % p2b.FR
                for ws in words.tolist()]
        return torch.from_numpy(p2b.to_limbs(vals)).to(dev)

    def equal(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want.to(got.device)):
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               "version")

    out = []

    def record(name, shape, ms, bound_ms, bound_by):
        rec = {"kernel": name, "shape": list(shape), "ms": round(ms, 4),
               "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
               "share_of_bound": round(bound_ms / ms, 4), "card": smi}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    a, b = rand_field(FLAGSHIP_SHAPE), rand_field(FLAGSHIP_SHAPE)
    equal("gl_mul", ck.gl_mul(a, b), ck.gl_mul_plain(a, b))
    n_el = a.numel()
    bd, by = bound(3 * 8 * n_el, ops=n_el * OPS_MUL)
    record("gl_mul", FLAGSHIP_SHAPE, cuda_ms(lambda: ck.gl_mul(a, b), 2, 10),
           bd, by)
    del a, b

    st = rand_field((P2_STATES, 12))
    equal("poseidon2_permute", ck.poseidon2_permute(st),
          ck.poseidon2_permute_plain(st))
    bd, by = bound(2 * 8 * 12 * P2_STATES,
                   ops=P2_STATES * (P2_MULS * OPS_MUL + P2_ADDS * OPS_ADD))
    record("poseidon2_permute", (P2_STATES, 12),
           cuda_ms(lambda: ck.poseidon2_permute(st), 2, 10), bd, by)
    del st

    params = p2b.get_params_bn254()
    n_fr = -(-FW_WIDTH // 3)
    perms_per_row = (n_fr + 1) // 2
    small = rand_field((FW_WIDTH, 64))
    equal("bn254_hash_rows", ck.bn254_hash_rows(small),
          ck.bn254_hash_rows_plain(small.cpu()))
    rows = rand_field((FW_WIDTH, FW_LEAVES))
    bd, by = bound(FW_WIDTH * FW_LEAVES * 8 + FW_LEAVES * 32,
                   ops_ms=bn254_bound_ms(params, FW_LEAVES * perms_per_row,
                                         FW_LEAVES * n_fr, FW_LEAVES))
    record("bn254_hash_rows", (FW_WIDTH, FW_LEAVES),
           cuda_ms(lambda: ck.bn254_hash_rows(rows), 1, 5), bd, by)
    del rows

    small = fr_limbs(128)
    equal("bn254_hash_pairs", ck.bn254_hash_pairs(small),
          ck.bn254_hash_pairs_plain(small.cpu()))
    pairs = fr_limbs(FW_LEAVES)
    m = FW_LEAVES // 2
    bd, by = bound(FW_LEAVES * 32 + FW_LEAVES * 16,
                   ops_ms=bn254_bound_ms(params, m, FW_LEAVES, m))
    record("bn254_hash_pairs", tuple(pairs.shape),
           cuda_ms(lambda: ck.bn254_hash_pairs(pairs), 1, 5), bd, by)
    del pairs
    torch.cuda.empty_cache()
    return out
