"""Flagship benchmark circuit: MainVM-shaped PLONKish geometry (PyTorch).

Counterpart of the JAX package's `circuits/flagship.py`: same IR, same setup,
same witness from the same seed.

A synthetic circuit with the reference MainVM's *shape* characteristics
(circuit_definitions base_layer/vm_main.rs:29-44 — ~130 copy columns, gate
degree up to 8, specialized lookups; TARGET_CIRCUIT_TRACE_LENGTH = 2^20) used
as the proving benchmark until the real zkEVM gate library lands:
  - a degree-7 S-box gate (Poseidon2-style x^7),
  - a chain of degree-2 mul-add gates across columns (row-local, so the
    witness builds fully vectorized on device),
  - copy-permutation wiring between two columns on every row,
  - a 2^16 range-check lookup on a dedicated column.
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..prover import plonkish as pk

P = gl.P


def flagship_ir(log_n: int = 16, width: int = 32) -> pk.PlonkishIR:
    assert width >= 8
    chain = list(range(3, width - 2))  # cols defined by the mul-add chain

    def eval_gates(alg, w, w_next, c):
        out = [alg.mul(c[0], alg.sub(alg.mul(alg.mul(
            alg.mul(w[0], w[0]), alg.mul(w[0], w[0])),
            alg.mul(alg.mul(w[0], w[0]), w[0])), w[1]))]  # w1 = w0^7
        for j in chain:
            out.append(alg.mul(c[0], alg.sub(
                alg.add_int(alg.mul(w[j - 1], w[j - 2]), j), w[j])))
        return out

    def eval_sbox(alg, w, w_next, c):
        return [alg.mul(c[0], alg.sub(alg.mul(alg.mul(
            alg.mul(w[0], w[0]), alg.mul(w[0], w[0])),
            alg.mul(alg.mul(w[0], w[0]), w[0])), w[1]))]

    def eval_chain(alg, w, w_next, c):
        return [alg.mul(c[0], alg.sub(
            alg.add_int(alg.mul(w[j - 1], w[j - 2]), j), w[j]))
            for j in chain]

    table = np.arange(min(1 << 16, 1 << log_n), dtype=object).reshape(-1, 1)
    return pk.PlonkishIR(
        log_n=log_n, num_witness=width, num_const=1, gate_degree=8,
        num_gate_constraints=1 + len(chain), eval_gates=eval_gates,
        copy_chunk=4,
        public_input_cells=((0, 0), (1, 0)),
        lookup_tables=(table,),
        lookup_sets=((0, (width - 1,)),),
        # degree stratification (prover-only, bit-identical proofs): ONLY
        # the S-box gate is degree 8; the mul-add chain is sel*w*w -> 3,
        # so its quotient (< 2n) needs 2 of the 8 cosets, copy (chunk 4)
        # needs 4, and lookup/boundary/PI need 1 — the bulk of the coset
        # NTT + eval work runs on a fraction of the domain
        eval_gates_parts=(eval_sbox, eval_chain),
        gate_part_counts=(1, len(chain)),
        gate_part_degrees=(8, 3),
        gate_part_cols=((0, 1), tuple(range(1, width - 2))),
    )


def flagship_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                   device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    n = 1 << ir.log_n
    width = ir.num_witness
    const_cols = np.ones((1, n), dtype=object)
    # wire col (width-2) to col 3 on every row
    rows = np.arange(n)
    wiring = pk.wire_copy_pairs(n, np.stack([np.full(n, 3), rows], 1),
                                np.stack([np.full(n, width - 2), rows], 1))
    return pk.build_setup(ir, const_cols, wiring, cfg, device=device)


def flagship_witness(ir: pk.PlonkishIR, seed: int = 0,
                     device=None) -> gl.GF:
    """Satisfying witness, built vectorized on `device` (row-local gates);
    `None` means the CUDA card. The random columns are drawn with
    numpy's default_rng(seed), so the JAX package builds the same trace from
    the same seed."""
    device = gl.resolve_device(device)
    n = 1 << ir.log_n
    width = ir.num_witness
    rng = np.random.default_rng(seed)
    cols = [None] * width
    cols[0] = gl.from_u64(rng.integers(0, 1 << 63, size=n, dtype=np.uint64),
                          device)
    cols[1] = gl.pow7(cols[0])
    cols[2] = gl.from_u64(rng.integers(0, 1 << 63, size=n, dtype=np.uint64),
                          device)
    for j in range(3, width - 2):
        prod = gl.mul(cols[j - 1], cols[j - 2])
        cols[j] = gl.add(prod, gl.scalar_like(j, prod))
    cols[width - 2] = cols[3]  # copy wire
    tbl_size = min(1 << 16, n)
    cols[width - 1] = gl.from_u64(
        (np.arange(n, dtype=np.uint64) % np.uint64(tbl_size)),
        device)  # lookup col
    return gl.stack(cols, axis=0)
