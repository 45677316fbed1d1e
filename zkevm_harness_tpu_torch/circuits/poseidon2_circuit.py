"""In-circuit Poseidon2: a PLONKish circuit proving permutation chains.

The first real cryptographic gadget circuit — the building block for
in-circuit Merkle/queue verification and hence the recursion layer (the
reference's recursive hasher `CircuitGoldilocksPoseidon2Sponge`,
src/prover_utils.rs:44).

Layout: 32 rows per permutation (exactly 1 initial-linear + 8 external + 22
internal transitions + 1 free output row):
  - 12 witness columns = the running state;
  - const columns: 12 round-constant columns + 3 selectors
    (s_lin / s_ext / s_int); row 31 of each block has all selectors 0, so the
    next block's input row is unconstrained (chain independence);
  - transition constraints (degree <= 8, one per lane):
      s_lin * (next - M_E s)  +  s_ext * (next - M_E (s+rc)^7)
      + s_int * (next - M_I s')     with s' = s except lane0 -> (s0+rc0)^7.

Public inputs: block 0's input state (row 0) and output state (row 31).

Counterpart of the JAX package's `circuits/poseidon2_circuit.py`. The
`_alg` helpers and `_block_const_rows` are the Poseidon2 round layout that
the RAM-permutation and narrow-queue sponge tiles share.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import M4, R_F, R_P, T, get_params
from ..prover import plonkish as pk

P = gl.P
ROWS_PER_PERMUTATION = 32
NUM_SELECTORS = 3  # s_lin, s_ext, s_int


def _apply_m4_alg(alg, vals4):
    out = []
    for i in range(4):
        acc = None
        for j in range(4):
            c = int(M4[i, j])
            term = alg.mul_int(vals4[j], c) if c != 1 else vals4[j]
            acc = term if acc is None else alg.add(acc, term)
        out.append(acc)
    return out


def _external_linear_alg(alg, state):
    mixed = []
    for c in range(3):
        mixed.extend(_apply_m4_alg(alg, state[4 * c:4 * c + 4]))
    totals = [alg.add(alg.add(mixed[i], mixed[i + 4]), mixed[i + 8])
              for i in range(4)]
    return [alg.add(mixed[i], totals[i % 4]) for i in range(12)]


def _internal_linear_alg(alg, state, diag):
    total = state[0]
    for s in state[1:]:
        total = alg.add(total, s)
    return [alg.add(alg.mul_int(state[i], int(diag[i])), total)
            for i in range(T)]


def _pow7_alg(alg, x):
    x2 = alg.mul(x, x)
    x4 = alg.mul(x2, x2)
    return alg.mul(alg.mul(x4, x2), x)


def poseidon2_ir(log_n: int) -> pk.PlonkishIR:
    assert (1 << log_n) % ROWS_PER_PERMUTATION == 0
    params = get_params()
    diag = params["internal_diag"]

    def eval_gates(alg, w, w_next, c):
        rc = c[:T]
        s_lin, s_ext, s_int = c[T], c[T + 1], c[T + 2]
        state = list(w)
        nxt = list(w_next)
        # linear: next - M_E s
        lin_out = _external_linear_alg(alg, state)
        # external: next - M_E (s + rc)^7
        sboxed = [_pow7_alg(alg, alg.add(state[i], rc[i])) for i in range(T)]
        ext_out = _external_linear_alg(alg, sboxed)
        # internal: next - M_I s'   (lane0 sboxed)
        s_prime = list(state)
        s_prime[0] = _pow7_alg(alg, alg.add(state[0], rc[0]))
        int_out = _internal_linear_alg(alg, s_prime, diag)
        out = []
        for i in range(T):
            t1 = alg.mul(s_lin, alg.sub(nxt[i], lin_out[i]))
            t2 = alg.mul(s_ext, alg.sub(nxt[i], ext_out[i]))
            t3 = alg.mul(s_int, alg.sub(nxt[i], int_out[i]))
            out.append(alg.add(alg.add(t1, t2), t3))
        return out

    pis = tuple((c, 0) for c in range(T)) + \
        tuple((c, ROWS_PER_PERMUTATION - 1) for c in range(T))
    return pk.PlonkishIR(
        log_n=log_n, num_witness=T, num_const=T + NUM_SELECTORS,
        gate_degree=8, num_gate_constraints=T, eval_gates=eval_gates,
        copy_chunk=4, public_input_cells=pis)


def _block_const_rows():
    """(32, T + 3) round constants + selectors per row of one block."""
    params = get_params()
    ext = params["external_initial"] + params["external_final"]
    internal = params["internal"]
    rows = np.zeros((ROWS_PER_PERMUTATION, T + NUM_SELECTORS), dtype=object)
    half = R_F // 2
    rows[0, T] = 1  # s_lin
    for r in range(half):  # rows 1..4: external
        rows[1 + r, :T] = ext[r]
        rows[1 + r, T + 1] = 1
    for r in range(R_P):  # rows 5..26: internal
        rows[1 + half + r, 0] = internal[r]
        rows[1 + half + r, T + 2] = 1
    for r in range(half):  # rows 27..30: external
        rows[1 + half + R_P + r, :T] = ext[half + r]
        rows[1 + half + R_P + r, T + 1] = 1
    # row 31: all zero (free output row)
    return rows


def poseidon2_setup(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                    device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    n = 1 << ir.log_n
    block = _block_const_rows()
    tiled = np.tile(block, (n // ROWS_PER_PERMUTATION, 1)).T  # (T+3, n)
    return pk.build_setup(ir, tiled, pk.CopyWiring.identity(), cfg,
                          device=device)


def poseidon2_witness(ir: pk.PlonkishIR, inputs: Sequence[Sequence[int]],
                      device=None) -> gl.GF:
    """Row-by-row exact trace for a list of input states (one per block),
    in host ints, handed to `device` (`None` means the CUDA card)."""
    n = 1 << ir.log_n
    n_blocks = n // ROWS_PER_PERMUTATION
    assert len(inputs) <= n_blocks
    params = get_params()
    ext = params["external_initial"] + params["external_final"]
    internal = params["internal"]
    diag = params["internal_diag"]
    half = R_F // 2

    def m_e(s):
        mixed = []
        for c in range(3):
            chunk = s[4 * c:4 * c + 4]
            mixed.extend(sum(int(M4[i, j]) * chunk[j] for j in range(4)) % P
                         for i in range(4))
        tot = [(mixed[i] + mixed[i + 4] + mixed[i + 8]) % P for i in range(4)]
        return [(mixed[i] + tot[i % 4]) % P for i in range(12)]

    rows = np.zeros((n, T), dtype=object)
    blocks = list(inputs) + [[0] * T] * (n_blocks - len(inputs))
    for b, inp in enumerate(blocks):
        s = [int(v) % P for v in inp]
        r0 = b * ROWS_PER_PERMUTATION
        rows[r0] = s
        s = m_e(s)
        rows[r0 + 1] = s
        ri = 2
        for r in range(half):
            s = m_e([pow((x + rc) % P, 7, P) for x, rc in zip(s, ext[r])])
            rows[r0 + ri] = s
            ri += 1
        for r in range(R_P):
            sp = list(s)
            sp[0] = pow((s[0] + internal[r]) % P, 7, P)
            tot = sum(sp) % P
            s = [(int(diag[i]) * sp[i] + tot) % P for i in range(T)]
            rows[r0 + ri] = s
            ri += 1
        for r in range(half):
            s = m_e([pow((x + rc) % P, 7, P) for x, rc in zip(s, ext[half + r])])
            rows[r0 + ri] = s
            ri += 1
        assert ri == ROWS_PER_PERMUTATION
    return gl.from_int(rows.T, device)  # (T, n)
