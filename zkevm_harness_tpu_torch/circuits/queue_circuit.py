"""Queue-commitment circuit: Poseidon2 sponge chain with copy-wired states.

Counterpart of the JAX package's `circuits/queue_circuit.py`. Proves the
FULL-WIDTH queue hash chain
    state_{k+1} = P2(overwrite(state_k, enc_k(8)))
the in-circuit counterpart of the witness-side FullWidthQueueSimulator
(circuit_encodings/src/lib.rs:391-429: memory / decommittment / recursion
queues).

Built on the Poseidon2 permutation blocks (circuits/poseidon2_circuit.py):
each push overwrites the rate lanes (0..7) with the encoding, so only the
capacity lanes (8..11) carry over between pushes: block k's OUTPUT lanes
8..11 (row 32k+31) are copy-wired into block k+1's INPUT lanes 8..11
(row 32k+32). Encoding lanes are free witness; public inputs bind the head
state's capacity lanes and the final tail (all 12 lanes of the last output
row). The chain's states are computed in exact host ints.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops import cuda_kernels as ck
from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from . import poseidon2_circuit as p2c
from .poseidon2_circuit import ROWS_PER_PERMUTATION, T

P = gl.P
NUM_PUBLIC_INPUTS = 4 + T  # head capacity lanes + full 12-lane tail


def queue_ir(log_n: int) -> pk.PlonkishIR:
    base = p2c.poseidon2_ir(log_n)
    n_blocks = (1 << log_n) // ROWS_PER_PERMUTATION
    last_out_row = (n_blocks - 1) * ROWS_PER_PERMUTATION + ROWS_PER_PERMUTATION - 1
    pis = tuple((8 + c, 0) for c in range(4)) + \
        tuple((c, last_out_row) for c in range(T))
    return pk.PlonkishIR(
        log_n=base.log_n, num_witness=base.num_witness,
        num_const=base.num_const, gate_degree=base.gate_degree,
        num_gate_constraints=base.num_gate_constraints,
        eval_gates=base.eval_gates, copy_chunk=base.copy_chunk,
        public_input_cells=pis)


def queue_wiring(n: int) -> pk.CopyWiring:
    """The capacity lanes of each block's output row wired to the next
    block's input row (disjoint two-cell cycles)."""
    k = np.arange(n // ROWS_PER_PERMUTATION - 1, dtype=np.int64)
    out_row = k * ROWS_PER_PERMUTATION + ROWS_PER_PERMUTATION - 1
    lanes = np.arange(8, T, dtype=np.int64)
    a = np.stack(np.broadcast_arrays(lanes[None, :], out_row[:, None]),
                 axis=-1).reshape(-1, 2)
    b = np.stack(np.broadcast_arrays(lanes[None, :], out_row[:, None] + 1),
                 axis=-1).reshape(-1, 2)
    return pk.wire_copy_pairs(n, a, b)


def queue_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    n = 1 << ir.log_n
    block = p2c._block_const_rows()
    tiled = np.tile(block, (n // ROWS_PER_PERMUTATION, 1)).T
    return pk.build_setup(ir, tiled, queue_wiring(n), cfg, device=device)


def queue_witness(ir: pk.PlonkishIR, encodings: Sequence[Sequence[int]],
                  head: Sequence[int] = (0,) * T, device=None) -> gl.GF:
    """Trace for a chain absorbing `encodings` starting from the 12-lane
    `head` state (only head[8:12] influences the chain: the rate lanes are
    overwritten by the first encoding, exactly like the simulator), handed
    to `device` (`None` means the CUDA card).

    Unused blocks continue the chain with zero encodings (still valid sponge
    steps), so the final tail PI reflects the PADDED chain; callers size the
    circuit to the queue (len(encodings) == n_blocks) for exact tails.
    """
    n = 1 << ir.log_n
    n_blocks = n // ROWS_PER_PERMUTATION
    assert len(encodings) <= n_blocks
    head = [int(v) % P for v in head]
    assert len(head) == T
    cap = head[8:]
    inputs = []
    for k in range(n_blocks):
        enc = (list(encodings[k]) if k < len(encodings) else [0] * 8)
        state = [int(v) % P for v in enc] + cap
        inputs.append(state)
        cap = ck.poseidon2_permute_ints(state)[8:]
    return p2c.poseidon2_witness(ir, inputs, device=device)


def expected_final_tail(encodings: Sequence[Sequence[int]], n_blocks: int,
                        head: Sequence[int] = (0,) * T) -> List[int]:
    """Full 12-lane tail after absorbing the (zero-padded) chain."""
    state = [int(v) % P for v in head]
    for k in range(n_blocks):
        enc = list(encodings[k]) if k < len(encodings) else [0] * 8
        state = ck.poseidon2_permute_ints(
            [int(v) % P for v in enc] + state[8:])
    return state
