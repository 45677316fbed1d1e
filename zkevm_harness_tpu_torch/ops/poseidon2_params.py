"""Poseidon2-over-Goldilocks parameter set (t=12, R_F=8, R_P=22, alpha=7).

The round constants and the internal-matrix diagonal are read from this
package's own `params/poseidon2_goldilocks.json` — a byte-identical copy of
the JAX package's table (pinned by tests/test_torch_poseidon2.py). The file
is the single swap point; it is read, never regenerated.

External matrix: circ(2*M4, M4, M4) with the Poseidon2 paper's M4.
Internal matrix: all-ones + diag(mu).
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

T = 12  # state width
RATE = 8
CAPACITY = 4
R_F = 8  # external (full) rounds, split 4 + 4
R_P = 22  # internal (partial) rounds
ALPHA = 7  # S-box exponent, gcd(7, p-1) = 1

# 4x4 block of the external linear layer (Poseidon2 paper, sec. 5.1)
M4 = np.array(
    [[5, 7, 1, 3],
     [4, 6, 1, 1],
     [1, 3, 5, 7],
     [1, 1, 4, 6]], dtype=np.int64)

PARAMS_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "params", "poseidon2_goldilocks.json"))


@functools.lru_cache(maxsize=None)
def get_params() -> dict:
    with open(PARAMS_PATH) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def const_tables_u64():
    """(external (R_F, T), internal (R_P,), diag (T,)) as numpy uint64."""
    p = get_params()
    ext = np.array(p["external_initial"] + p["external_final"],
                   dtype=np.uint64)
    internal = np.array(p["internal"], dtype=np.uint64)
    diag = np.array(p["internal_diag"], dtype=np.uint64)
    assert ext.shape == (R_F, T) and internal.shape == (R_P,)
    assert diag.shape == (T,)
    return ext, internal, diag
