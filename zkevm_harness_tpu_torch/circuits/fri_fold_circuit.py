"""FRI fold-check circuit (verifier-plan step 3).

Counterpart of the JAX package's `circuits/fri_fold_circuit.py`. One row per
(query, layer) fold verification:
    next = (a + b)/2 + alpha * (a - b) * d_inv / 2        (ext arithmetic)
with a provided-inverse cell enforcing d * d_inv == 1 — exactly the per-query
check `prover/fri.fri_verify` runs on the host. The domain point d is bound
per row through a constant column (the verifier knows the query positions,
so d is setup/public data); a, b, alpha, next are witness.

Setups and witnesses take `device`: `None` means the CUDA card (raises where
there is none).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from ..utils import field_int as fi

P = gl.P
INV2 = pow(2, P - 2, P)
# witness columns
A0, A1, B0, B1, AL0, AL1, DINV, N0, N1 = range(9)
# const columns: q (active), d (domain point)
NUM_WITNESS = 9


def fold_ir(log_n: int) -> pk.PlonkishIR:
    def eval_gates(alg, w, w_next, c):
        q, d = c[0], c[1]
        one = alg.add_int(alg.mul_int(w[DINV], 0), 1)
        # d * d_inv == 1 on active rows
        g_inv = alg.mul(q, alg.sub(alg.mul(d, w[DINV]), one))
        # h = d_inv / 2 (base); o = (a - b) * h (ext, component-wise base mul)
        h = alg.mul_int(w[DINV], INV2)
        o0 = alg.mul(alg.sub(w[A0], w[B0]), h)
        o1 = alg.mul(alg.sub(w[A1], w[B1]), h)
        # e = (a + b) / 2
        e0 = alg.mul_int(alg.add(w[A0], w[B0]), INV2)
        e1 = alg.mul_int(alg.add(w[A1], w[B1]), INV2)
        # alpha * o  (ext mul, x^2 = 7)
        ao0 = alg.add(alg.mul(w[AL0], o0), alg.mul_int(alg.mul(w[AL1], o1), 7))
        ao1 = alg.add(alg.mul(w[AL0], o1), alg.mul(w[AL1], o0))
        g0 = alg.mul(q, alg.sub(w[N0], alg.add(e0, ao0)))
        g1 = alg.mul(q, alg.sub(w[N1], alg.add(e1, ao1)))
        return [g_inv, g0, g1]

    return pk.PlonkishIR(log_n=log_n, num_witness=NUM_WITNESS, num_const=2,
                         gate_degree=4, num_gate_constraints=3,
                         eval_gates=eval_gates, copy_chunk=3,
                         public_input_cells=((N0, 0), (N1, 0)))


def fold_setup(ir: pk.PlonkishIR, domain_points: Sequence[int],
               cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """domain_points[i] = d for row i (0 deactivates the row)."""
    n = 1 << ir.log_n
    consts = np.zeros((2, n), dtype=object)
    for i, d in enumerate(domain_points):
        if int(d) != 0:
            consts[0, i] = 1
            consts[1, i] = int(d) % P
    return pk.build_setup(ir, consts, pk.CopyWiring.identity(), cfg,
                          device=device)


def fold_witness(ir: pk.PlonkishIR, rows: Sequence[Tuple],
                 device=None) -> Tuple[gl.GF, List[Tuple[int, int]]]:
    """rows: (a, b, alpha, d) ext/ext/ext/base per active row.
    Returns (witness, expected folded values)."""
    n = 1 << ir.log_n
    w = np.zeros((n, NUM_WITNESS), dtype=object)
    folded = []
    for i, (a, b, alpha, d) in enumerate(rows):
        d = int(d) % P
        dinv = pow(d, P - 2, P)
        e = fi.escale(fi.eadd(a, b), INV2)
        o = fi.escale(fi.esub(a, b), INV2 * dinv % P)
        nxt = fi.eadd(e, fi.emul(alpha, o))
        w[i] = [a[0], a[1], b[0], b[1], alpha[0], alpha[1], dinv,
                nxt[0], nxt[1]]
        folded.append(nxt)
    return gl.from_int(w.T, device), folded
