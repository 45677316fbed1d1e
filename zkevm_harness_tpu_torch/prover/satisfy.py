"""Host-side PLONKish satisfiability checker (no proving).

The TPU-native analogue of the reference's `check_if_satisfied` under
DevCSConfig (src/tests/mod.rs:130-259): evaluate every gate constraint on
every row exactly (numpy object ints mod p), check the copy permutation,
lookup membership, and public-input cells — and report precise violation
locations. Used by circuit tests before paying for a full proof, exactly the
reference's test strategy (SURVEY §4 tier 2).

Counterpart of the JAX package's `prover/satisfy.py`. The copy permutation
is the port's `plonkish.CopyWiring` (the moved cells and their successors)
where the JAX package takes the dense (num_witness, n, 2) successor array;
the cells are checked in the same (column, row) order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..ops import goldilocks as gl
from . import plonkish as pk

P = gl.P


class HostNpAlgebra:
    """Gate algebra over numpy object arrays (exact ints mod p)."""

    def add(self, a, b):
        return (a + b) % P

    def sub(self, a, b):
        return (a - b) % P

    def mul(self, a, b):
        return (a * b) % P

    def mul_int(self, a, c: int):
        return (a * (c % P)) % P

    def add_int(self, a, c: int):
        return (a + (c % P)) % P


def check_satisfied(ir: pk.PlonkishIR, witness_int: np.ndarray,
                    const_int: np.ndarray, wiring: pk.CopyWiring,
                    public_inputs: Optional[Sequence[int]] = None,
                    max_violations: int = 20) -> List[str]:
    """Return a list of human-readable violations (empty = satisfied).

    witness_int: (num_witness, n) ints; const_int: (num_const, n); wiring:
    the copy permutation as in build_setup.
    """
    n = 1 << ir.log_n
    W = np.asarray(witness_int, dtype=object) % P
    C = np.asarray(const_int, dtype=object) % P
    assert W.shape == (ir.num_witness, n), W.shape
    assert C.shape == (ir.num_const, n), C.shape
    out: List[str] = []

    w = [W[c] for c in range(ir.num_witness)]
    w_next = [np.roll(W[c], -1) for c in range(ir.num_witness)]
    c = [C[j] for j in range(ir.num_const)]
    vals = ir.eval_gates(HostNpAlgebra(), w, w_next, c)
    assert len(vals) == ir.num_gate_constraints, (
        f"eval_gates returned {len(vals)} constraints, IR declares "
        f"{ir.num_gate_constraints}")
    for k, v in enumerate(vals):
        bad = np.nonzero(np.asarray(v, dtype=object) % P)[0]
        for r in bad[:3]:
            out.append(f"gate[{k}] row {int(r)}: value {int(v[r]) % P}")
        if len(out) >= max_violations:
            return out

    # copy permutation: value at each cell == value at its successor
    order = np.argsort(wiring.cells, kind="stable")
    cells, succ = wiring.cells[order], wiring.succ[order]
    flat = W.reshape(-1)
    bad = np.flatnonzero((flat[cells] - flat[succ]) % P != 0)
    for k in bad[:3]:
        (col, row), (sc, sr) = divmod(int(cells[k]), n), divmod(
            int(succ[k]), n)
        out.append(f"copy ({col},{row})={int(W[col, row])} != "
                   f"({sc},{sr})={int(W[sc, sr])}")
    if len(out) >= max_violations:
        return out

    # lookups: every row of the listed columns must be a table row
    for s, (tbl_idx, cols) in enumerate(ir.lookup_sets):
        table = np.asarray(ir.lookup_tables[tbl_idx], dtype=object) % P
        entries = {tuple(int(x) for x in row) for row in table}
        stacked = W[list(cols)].T  # (n, L)
        for r in range(n):
            if tuple(int(x) for x in stacked[r]) not in entries:
                out.append(f"lookup set {s} row {r}: "
                           f"{[int(x) for x in stacked[r]]} not in table")
                break
        if len(out) >= max_violations:
            return out

    if public_inputs is not None:
        assert len(public_inputs) == len(ir.public_input_cells)
        for i, ((col, row), exp) in enumerate(
                zip(ir.public_input_cells, public_inputs)):
            if int(W[col, row]) != int(exp) % P:
                out.append(f"PI[{i}] cell ({col},{row}) = {int(W[col, row])}"
                           f" != expected {int(exp) % P}")
    return out
