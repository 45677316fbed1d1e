"""GF(p^2) extension-field arithmetic in-circuit (FRI-verifier prerequisite).

Counterpart of the JAX package's `circuits/ext_gadget.py`. The recursive
verifier replays FRI folds over GoldilocksExt2; this gadget circuit
establishes the in-circuit ext operations: per row,
  (c0, c1) = (a0, a1) * (b0, b1)  with x^2 = 7:
      c0 = a0*b0 + 7*a1*b1        c1 = a0*b1 + a1*b0     (degree 2)
and a squaring chain wired by copy constraints (row i's product feeds row
i+1's operands), proving a^(2^n) — the exponentiation pattern FRI fold
challenges and DEEP denominators need.

Setups and witnesses take `device`: `None` means the CUDA card (raises where
there is none).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from ..utils import field_int as fi

P = gl.P
A0, A1, B0, B1, C0, C1 = range(6)


def ext_chain_ir(log_n: int) -> pk.PlonkishIR:
    def eval_gates(alg, w, w_next, c):
        q = c[0]
        t0 = alg.add(alg.mul(w[A0], w[B0]),
                     alg.mul_int(alg.mul(w[A1], w[B1]), 7))
        t1 = alg.add(alg.mul(w[A0], w[B1]), alg.mul(w[A1], w[B0]))
        return [alg.mul(q, alg.sub(w[C0], t0)),
                alg.mul(q, alg.sub(w[C1], t1))]

    n = 1 << log_n
    pis = ((A0, 0), (A1, 0), (C0, n - 2), (C1, n - 2))
    return pk.PlonkishIR(log_n=log_n, num_witness=6, num_const=1,
                         gate_degree=3, num_gate_constraints=2,
                         eval_gates=eval_gates, copy_chunk=3,
                         public_input_cells=pis)


def ext_chain_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                    device=None) -> pk.PlonkishSetup:
    n = 1 << ir.log_n
    q = np.ones((1, n), dtype=object)
    q[0, n - 1] = 0  # last row free
    # every copied value forms ONE cycle (a cell may appear in only one):
    # row 0: a == b; then c_i feeds both operands of row i+1
    cycles = [[(A0, 0), (B0, 0)], [(A1, 0), (B1, 0)]]
    for i in range(n - 2):
        cycles.append([(C0, i), (A0, i + 1), (B0, i + 1)])
        cycles.append([(C1, i), (A1, i + 1), (B1, i + 1)])
    return pk.build_setup(ir, q, pk.wire_copy_cycles(n, cycles), cfg,
                          device=device)


def ext_chain_witness(ir: pk.PlonkishIR, a: Tuple[int, int],
                      device=None) -> gl.GF:
    """Trace squaring a -> a^2 -> a^4 ... ; returns the (6, n) witness."""
    n = 1 << ir.log_n
    rows = np.zeros((n, 6), dtype=object)
    cur = (int(a[0]) % P, int(a[1]) % P)
    for i in range(n - 1):
        sq = fi.emul(cur, cur)
        rows[i] = [cur[0], cur[1], cur[0], cur[1], sq[0], sq[1]]
        cur = sq
    return gl.from_int(rows.T, device)


def expected_power(a: Tuple[int, int], log_n: int) -> Tuple[int, int]:
    """The chain result at row n-2: a^(2^(n-1))."""
    return fi.epow((int(a[0]) % P, int(a[1]) % P), 1 << ((1 << log_n) - 1))


# --------------------------------------------------------------------------
# Inverse cells (verifier-plan step 2): x * x_inv == 1 constraints
# --------------------------------------------------------------------------

def inverse_ir(log_n: int) -> pk.PlonkishIR:
    """Rows of (x, x_inv) with q * (x * x_inv - 1) = 0 — the pattern backing
    Z_H division, DEEP denominators and FRI fold d-inverses in the recursive
    verifier (provided-inverse technique: the witness supplies the inverse,
    the gate enforces it, and x = 0 is unsatisfiable on active rows)."""

    def eval_gates(alg, w, w_next, c):
        one = alg.add_int(alg.mul_int(w[0], 0), 1)
        return [alg.mul(c[0], alg.sub(alg.mul(w[0], w[1]), one))]

    return pk.PlonkishIR(log_n=log_n, num_witness=2, num_const=1,
                         gate_degree=3, num_gate_constraints=1,
                         eval_gates=eval_gates, copy_chunk=2,
                         public_input_cells=((0, 0), (1, 0)))


def inverse_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                  active_rows: int, device=None) -> pk.PlonkishSetup:
    n = 1 << ir.log_n
    q = np.zeros((1, n), dtype=object)
    q[0, :active_rows] = 1
    return pk.build_setup(ir, q, pk.CopyWiring.identity(), cfg,
                          device=device)


def inverse_witness(ir: pk.PlonkishIR, xs: Sequence[int],
                    device=None) -> gl.GF:
    n = 1 << ir.log_n
    rows = np.zeros((n, 2), dtype=object)
    for i, x in enumerate(xs):
        x = int(x) % P
        assert x != 0, "cannot build an inverse witness for zero"
        rows[i] = [x, pow(x, P - 2, P)]
    return gl.from_int(rows.T, device)
