"""Host cost of the BN254 Poseidon2 permutation that a for-wrapper
compression tree hashes with (the JAX package's `utils/poseidon2_bn254.py`,
host Python ints), and what it gives for one tree at a given shape:

    python tools/time_bn254_permutation.py [--perms 2000] [--log-rows 17]
        [--width 72] [--rate 2]

A for-wrapper tree hashes each leaf row of `width` Goldilocks values in
ceil(width / 2) permutations (two values a BN254 element), over
rows * rate leaves. Host seconds of the machine it runs on; no device.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from zkevm_harness_tpu.utils import poseidon2_bn254 as p2b  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perms", type=int, default=2000)
    ap.add_argument("--log-rows", type=int, default=17)
    ap.add_argument("--width", type=int, default=72)
    ap.add_argument("--rate", type=int, default=2)
    args = ap.parse_args()
    state = [1, 2, 3]
    p2b.permute(state)  # parameters built outside the timed loop
    t0 = time.perf_counter()
    for _ in range(args.perms):
        state = p2b.permute(state)
    per_perm = (time.perf_counter() - t0) / args.perms
    leaves = args.rate << args.log_rows
    perms = leaves * -(-args.width // 2)
    print(f"permutation: {per_perm * 1e6:.1f} us over {args.perms}")
    print(f"tree of {leaves} leaves x {args.width} values: {perms} "
          f"permutations, {perms * per_perm / 60:.1f} min")


if __name__ == "__main__":
    main()
