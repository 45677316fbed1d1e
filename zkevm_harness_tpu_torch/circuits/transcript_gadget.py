"""In-circuit Fiat-Shamir transcript (verifier-plan step 1).

Counterpart of the JAX package's `circuits/transcript_gadget.py`. Replays
`prover/transcript.Transcript` inside a circuit: the overwrite-mode rate-8
absorption IS the queue-commitment sponge chain (lanes 0..7 overwritten per
block, capacity lanes 8..11 carried by copy wiring), and a squeezed
challenge is simply an output-row cell — so challenge extraction is
public-input binding on the right cells.

`transcript_ir(log_n, challenge_blocks)` builds a circuit absorbing
(1 << log_n)/32 rate-chunks whose public inputs are:
  - the initial capacity lanes (must be 0 for a fresh transcript),
  - (c0, c1) = output lanes 0..1 after each block in `challenge_blocks` —
    exactly `Transcript.challenge_ext_ints()` drawn at those points.

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
from . import queue_circuit as qc
from .poseidon2_circuit import ROWS_PER_PERMUTATION, T

P = gl.P


def transcript_ir(log_n: int, challenge_blocks: Sequence[int]) -> pk.PlonkishIR:
    base = qc.queue_ir(log_n)
    n_blocks = (1 << log_n) // ROWS_PER_PERMUTATION
    assert all(0 <= b < n_blocks for b in challenge_blocks)
    pis = tuple((8 + c, 0) for c in range(4))  # fresh-capacity binding
    for b in challenge_blocks:
        out_row = b * ROWS_PER_PERMUTATION + ROWS_PER_PERMUTATION - 1
        pis += ((0, out_row), (1, out_row))
    return pk.PlonkishIR(
        log_n=base.log_n, num_witness=base.num_witness,
        num_const=base.num_const, gate_degree=base.gate_degree,
        num_gate_constraints=base.num_gate_constraints,
        eval_gates=base.eval_gates, copy_chunk=base.copy_chunk,
        public_input_cells=pis)


def transcript_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                     device=None) -> pk.PlonkishSetup:
    """Like the queue circuit, carrying the CAPACITY lanes: block k's output
    lanes 8..11 wire into block k+1's input lanes 8..11 (sponge state
    continuation)."""
    n = 1 << ir.log_n
    block = p2c._block_const_rows()
    tiled = np.tile(block, (n // ROWS_PER_PERMUTATION, 1)).T
    return pk.build_setup(ir, tiled, qc.queue_wiring(n), cfg, device=device)


def transcript_witness(ir: pk.PlonkishIR,
                       absorb_chunks: Sequence[Sequence[int]],
                       device=None) -> gl.GF:
    """Trace the sponge: block k input = [chunk_k(8) || prev_output[8:12]]
    (overwrite absorption; zero chunks pad unused blocks). The states are
    permuted in exact host ints."""
    n = 1 << ir.log_n
    n_blocks = n // ROWS_PER_PERMUTATION
    state_cap = [0, 0, 0, 0]
    inputs = []
    for k in range(n_blocks):
        chunk = (list(absorb_chunks[k]) if k < len(absorb_chunks)
                 else [0] * 8)
        full_in = [int(v) % P for v in chunk] + state_cap
        inputs.append(full_in)
        state_cap = ck.poseidon2_permute_ints(full_in)[8:12]
    return p2c.poseidon2_witness(ir, inputs, device=device)


def expected_challenges(absorb_chunks: Sequence[Sequence[int]],
                        challenge_blocks: Sequence[int],
                        device=None) -> List[Tuple[int, int]]:
    """The Transcript's challenge at each extraction point."""
    from ..prover.transcript import Transcript

    out = []
    for b in sorted(challenge_blocks):
        tr = Transcript(device=device)
        for chunk in absorb_chunks[:b + 1]:
            tr.absorb_ints(list(chunk))
        out.append(tr.challenge_ext_ints())
    return out
