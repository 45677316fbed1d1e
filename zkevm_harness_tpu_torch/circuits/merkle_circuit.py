"""In-circuit Merkle path verification (generic path bits).

Counterpart of the JAX package's `circuits/merkle_circuit.py`. The
recursion-layer building block: proves knowledge of a Merkle authentication
path from a leaf digest to a cap digest under the Poseidon2 2-to-1 node
hash — the statement every FRI query check and recursive proof verification
reduces to.

Construction: one Poseidon2 permutation block (32 rows) per tree level,
built on circuits/poseidon2_circuit.py, with 9 extra witness columns active
on each block's row 0:
  prev(4)  — previous level's digest, copy-wired from the previous block's
             output lanes 0..3 (block 0's prev is the leaf digest, a PI);
  sib(4)   — the sibling digest at this level (free witness);
  bit(1)   — the path bit, constrained boolean.
Row-0 mux gates place (left, right) into the permutation input lanes:
  lanes[0..3] = bit ? sib : prev      lanes[4..7] = bit ? prev : sib
and zero the capacity lanes 8..11. Public inputs: leaf digest (block 0 row 0
prev columns), root digest (last block output lanes 0..3), and the path bits.

Setups and witnesses take `device`: `None` means the CUDA card (raises where
there is none).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..ops import cuda_kernels as ck
from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from . import poseidon2_circuit as p2c
from .poseidon2_circuit import NUM_SELECTORS, ROWS_PER_PERMUTATION, T

P = gl.P
PREV0 = T          # columns T..T+3: prev digest
SIB0 = T + 4       # columns T+4..T+7: sibling digest
BIT = T + 8        # column T+8: path bit
NUM_WITNESS = T + 9
S_MUX = T + NUM_SELECTORS  # const column index of the row-0 mux selector


def merkle_ir(log_n: int) -> pk.PlonkishIR:
    """Circuit with (1 << log_n)/32 tree levels."""
    base = p2c.poseidon2_ir(log_n)
    n_blocks = (1 << log_n) // ROWS_PER_PERMUTATION
    base_eval = base.eval_gates

    def eval_gates(alg, w, w_next, c):
        out = list(base_eval(alg, w[:T], w_next[:T], c))
        s_mux = c[T + NUM_SELECTORS]
        bit = w[BIT]
        one_minus = alg.sub(alg.add_int(alg.mul_int(bit, 0), 1), bit)
        # booleanity: s_mux * bit * (bit - 1)
        out.append(alg.mul(s_mux, alg.mul(bit, alg.sub(bit, alg.add_int(
            alg.mul_int(bit, 0), 1)))))
        for i in range(4):
            left = alg.add(alg.mul(bit, w[SIB0 + i]),
                           alg.mul(one_minus, w[PREV0 + i]))
            right = alg.add(alg.mul(bit, w[PREV0 + i]),
                            alg.mul(one_minus, w[SIB0 + i]))
            out.append(alg.mul(s_mux, alg.sub(w[i], left)))
            out.append(alg.mul(s_mux, alg.sub(w[4 + i], right)))
        # capacity lanes start at zero on absorb rows
        for i in range(8, 12):
            out.append(alg.mul(s_mux, w[i]))
        return out

    depth = n_blocks
    pis = (tuple((PREV0 + i, 0) for i in range(4))  # leaf digest
           + tuple((i, (depth - 1) * ROWS_PER_PERMUTATION
                    + ROWS_PER_PERMUTATION - 1) for i in range(4))  # root
           + tuple((BIT, b * ROWS_PER_PERMUTATION) for b in range(depth)))
    return pk.PlonkishIR(
        log_n=log_n, num_witness=NUM_WITNESS,
        num_const=T + NUM_SELECTORS + 1,  # + s_mux
        gate_degree=8,
        num_gate_constraints=base.num_gate_constraints + 1 + 8 + 4,
        eval_gates=eval_gates, copy_chunk=4, public_input_cells=pis)


def merkle_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                 device=None) -> pk.PlonkishSetup:
    n = 1 << ir.log_n
    n_blocks = n // ROWS_PER_PERMUTATION
    block = p2c._block_const_rows()  # (32, T+3)
    smux = np.zeros((ROWS_PER_PERMUTATION, 1), dtype=object)
    smux[0, 0] = 1
    block_full = np.concatenate([block, smux], axis=1)
    tiled = np.tile(block_full, (n_blocks, 1)).T
    cycles = []
    for k in range(n_blocks - 1):
        out_row = k * ROWS_PER_PERMUTATION + ROWS_PER_PERMUTATION - 1
        in_row = (k + 1) * ROWS_PER_PERMUTATION
        for c in range(4):
            cycles.append([(c, out_row), (PREV0 + c, in_row)])
    return pk.build_setup(ir, tiled, pk.wire_copy_cycles(n, cycles), cfg,
                          device=device)


def merkle_witness(ir: pk.PlonkishIR, leaf_digest: Sequence[int],
                   siblings: Sequence[Sequence[int]],
                   bits: Sequence[int],
                   device=None) -> Tuple[gl.GF, List[int]]:
    """Build the trace; returns (witness, root_digest)."""
    n = 1 << ir.log_n
    n_blocks = n // ROWS_PER_PERMUTATION
    assert len(siblings) == len(bits) == n_blocks
    prev = [int(v) % P for v in leaf_digest]
    perm_inputs = []
    aux_rows = np.zeros((n, 9), dtype=object)
    for k in range(n_blocks):
        sib = [int(v) % P for v in siblings[k]]
        b = int(bits[k])
        assert b in (0, 1)
        left, right = (sib, prev) if b else (prev, sib)
        state = left + right + [0, 0, 0, 0]
        perm_inputs.append(state)
        r0 = k * ROWS_PER_PERMUTATION
        aux_rows[r0, 0:4] = prev
        aux_rows[r0, 4:8] = sib
        aux_rows[r0, 8] = b
        prev = _permute4(state)
    core = p2c.poseidon2_witness(
        pk.PlonkishIR(log_n=ir.log_n, num_witness=T, num_const=0,
                      gate_degree=8, num_gate_constraints=0,
                      eval_gates=lambda *a: []),
        perm_inputs, device=device)
    full = gl.concatenate([core, gl.from_int(aux_rows.T, device)], axis=0)
    return full, prev


def _permute4(state: List[int]) -> List[int]:
    """Lanes 0..3 of one permuted state, in exact host ints (the lone-state
    permutation of the serial sponges, `cuda_kernels.poseidon2_permute_ints`)."""
    return ck.poseidon2_permute_ints(state)[:4]
