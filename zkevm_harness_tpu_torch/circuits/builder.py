"""Gadget-synthesis builder: arithmetic DAGs -> PlonkishIR circuits.

Counterpart of the JAX package's `circuits/builder.py`. Recursion-layer
circuits are programs (verify a FRI proof, aggregate children) lowered
onto a constraint system by a small circuit compiler:

  - an ARITHMETIC region of `slots` universal PLONK slots per row, each slot
    enforcing  q_m*a*b + q_l*a + q_r*b + q_o*c + q_c = 0  over three wires
    (degree 3), with the q-constants in const columns;
  - a POSEIDON2 region of 32-row permutation tiles (the layout of
    circuits/poseidon2_circuit.py), whose block input/output lanes are
    copy-wired to arithmetic wires;
  - variables are single field elements; every use-site cell of a variable
    joins one copy cycle, so equality is enforced by the copy permutation;
  - witness HINTS (prover-provided values such as inverses) are free
    variables whose defining property is enforced by explicit gates.

The same program gives the JAX package's IR, const columns, copy
permutation and witness, value for value. What differs is where the work
runs:
  - gates are kept as flat typed arrays and lowered with numpy: the const
    columns as uint64 arrays, the copy permutation as a `CopyWiring` of
    each multi-cell variable's cycle (cell i -> cell i+1, the last -> the
    first: what `apply_copy_cycles` makes of disjoint cycles), never the
    dense (width, n, 2) array;
  - `eval_values` runs the op list in exact Python ints, in rounds of
    dependency level: a permutation's inputs are earlier ops' values, so
    the permutations whose inputs are ready by the same round are permuted
    together, as one batch on the card (on the CPU one at a time,
    `cuda_kernels.poseidon2_permute_ints`);
  - `fill_witness` scatters the values into the slot columns with numpy and
    expands every permutation's 32 round rows in one batched call on the
    device (the RAM circuit's `_block_rows_device`);
  - the IR's two gate parts evaluate, on an algebra that `stacks_tiles`, as
    stacked tensors (the slots as (S, n), the tiles as (tiles, n, 12)), so
    that the launches per coset do not grow with S or the tile count; any
    other algebra (the host verifier, the in-circuit verifier's builder
    algebra, the satisfiability check) takes the per-constraint list path,
    whose calls are the JAX package's, in its order.
"""

from __future__ import annotations

import dataclasses
from array import array
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops import goldilocks as gl
from ..ops.poseidon2_params import T, const_tables_u64, get_params
from ..prover import plonkish as pk
from . import poseidon2_circuit as p2c
from . import ram_permutation_circuit as rpc

P = gl.P
ROWS_PER_PERMUTATION = p2c.ROWS_PER_PERMUTATION  # 32
_NO = -1  # unused wire

# op kinds of the recorded program
_INPUT, _CONST, _ADD, _SUB, _MUL, _LIN, _HINT, _PERM = range(8)


def perm_trace_host(state: Sequence[int]) -> np.ndarray:
    """(32, 12) exact row trace of one Poseidon2 permutation (block layout
    of circuits/poseidon2_circuit.py: input, linear, 4 ext, 22 int, 4 ext),
    as uint64."""
    rows = rpc._block_rows_device(
        gl.from_int(np.array([int(v) % P for v in state], dtype=object)
                    .reshape(1, T), "cpu"))
    return gl.to_u64(rows[0])


@dataclasses.dataclass
class BuiltCircuit:
    ir: pk.PlonkishIR
    const_cols: np.ndarray      # (num_const, n) uint64
    wiring: pk.CopyWiring
    layout: "CircuitBuilder"

    def setup(self, cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
        """`device=None` means the CUDA card (raises where there is none)."""
        return pk.build_setup(self.ir, self.const_cols, self.wiring, cfg,
                              device=device)


class CircuitBuilder:
    """Records a program of field ops + Poseidon2 permutations, then lowers
    it to (PlonkishIR, const columns, copy wiring) and evaluates it on
    concrete inputs to produce witness columns."""

    def __init__(self, slots: int = 8):
        self.S = slots
        self._gq = array("Q")  # 5 q-constants per gate
        self._gw = array("q")  # 3 wires per gate
        self.ops: List[Tuple] = []
        self.perms: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        self.n_vars = 0
        self.pi_vars: List[int] = []
        self._const_cache: Dict[int, int] = {}
        self._finalized = False
        self._zero: Optional[int] = None
        self._rounds = None  # the evaluation schedule, made at first use

    @property
    def num_gates(self) -> int:
        return len(self._gw) // 3

    def gate_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(G, 5) uint64 q-constants (qm, ql, qr, qo, qc) and (G, 3) int64
        wires (a, b, c; -1 where unused) of every gate, in order."""
        q = np.frombuffer(self._gq, dtype=np.uint64).reshape(-1, 5)
        w = np.frombuffer(self._gw, dtype=np.int64).reshape(-1, 3)
        return q.copy(), w.copy()

    def _gate(self, qm, ql, qr, qo, qc, a, b, c):
        self._gq.extend((qm, ql, qr, qo, qc))
        self._gw.extend((a, b, c))

    # -- variable creation -------------------------------------------------

    def _new(self) -> int:
        v = self.n_vars
        self.n_vars += 1
        return v

    def input(self) -> int:
        """A free input variable (set via assignments at witness time)."""
        v = self._new()
        self.ops.append((_INPUT, v))
        return v

    def inputs(self, k: int) -> List[int]:
        return [self.input() for _ in range(k)]

    def constant(self, c: int) -> int:
        c = int(c) % P
        if c in self._const_cache:
            return self._const_cache[c]
        v = self._new()
        self.ops.append((_CONST, v, c))
        self._gate(0, 1, 0, 0, (-c) % P, v, _NO, _NO)  # v - c = 0
        self._const_cache[c] = v
        return v

    @property
    def zero(self) -> int:
        if self._zero is None:
            self._zero = self.constant(0)
        return self._zero

    # -- arithmetic slots --------------------------------------------------

    def add(self, x: int, y: int) -> int:
        z = self._new()
        self.ops.append((_ADD, z, x, y))
        self._gate(0, 1, 1, P - 1, 0, x, y, z)
        return z

    def sub(self, x: int, y: int) -> int:
        z = self._new()
        self.ops.append((_SUB, z, x, y))
        self._gate(0, 1, P - 1, P - 1, 0, x, y, z)
        return z

    def mul(self, x: int, y: int) -> int:
        z = self._new()
        self.ops.append((_MUL, z, x, y))
        self._gate(1, 0, 0, P - 1, 0, x, y, z)
        return z

    def lin(self, ax: int, x: int, by: int = 0, y: int = _NO,
            c: int = 0) -> int:
        """z = ax*x + by*y + c."""
        z = self._new()
        ax, by, c = int(ax) % P, int(by) % P, int(c) % P
        self.ops.append((_LIN, z, ax, x, by, y, c))
        self._gate(0, ax, by, P - 1, c, x, y, z)
        return z

    def mul_int(self, x: int, c: int) -> int:
        return self.lin(c, x)

    def add_int(self, x: int, c: int) -> int:
        return self.lin(1, x, c=c)

    def mul_add(self, x: int, y: int, z: int) -> int:
        """x*y + z (two slots: the universal gate has only three wires)."""
        return self.add(self.mul(x, y), z)

    # -- constraints -------------------------------------------------------

    def assert_zero(self, x: int):
        self._gate(0, 1, 0, 0, 0, x, _NO, _NO)

    def assert_eq(self, x: int, y: int):
        self._gate(0, 1, P - 1, 0, 0, x, y, _NO)

    def assert_bool(self, x: int):
        self._gate(1, P - 1, 0, 0, 0, x, x, _NO)

    def assert_mul(self, x: int, y: int, z: int):
        """x * y == z without allocating a new variable."""
        self._gate(1, 0, 0, P - 1, 0, x, y, z)

    def assert_one(self, x: int):
        """x == 1 (the gate x - 1 = 0)."""
        self._gate(0, 1, 0, 0, P - 1, x, _NO, _NO)

    # -- hints (prover-provided values with explicit defining gates) -------

    def hint(self, fn: Callable[..., int], deps: Sequence[int]) -> int:
        v = self._new()
        self.ops.append((_HINT, v, fn, tuple(deps)))
        return v

    def inverse(self, x: int) -> int:
        """1/x with the provided-inverse pattern (x must be nonzero)."""
        inv = self.hint(lambda v: pow(int(v), P - 2, P), (x,))
        self._gate(1, 0, 0, 0, P - 1, x, inv, _NO)  # x * inv - 1 = 0
        return inv

    def bit(self, fn: Callable[..., int], deps: Sequence[int]) -> int:
        b = self.hint(fn, deps)
        self.assert_bool(b)
        return b

    def mux(self, b: int, x: int, y: int) -> int:
        """b ? x : y   (b boolean)."""
        d = self.sub(x, y)
        m = self.mul(b, d)
        return self.add(m, y)

    # -- Poseidon2 ---------------------------------------------------------

    def poseidon2(self, state: Sequence[int]) -> List[int]:
        assert len(state) == T
        outs = [self._new() for _ in range(T)]
        self.ops.append((_PERM, tuple(outs), tuple(state)))
        self.perms.append((tuple(state), tuple(outs)))
        return outs

    # -- public inputs -----------------------------------------------------

    def mark_public(self, var: int):
        self.pi_vars.append(var)

    # -- lowering ----------------------------------------------------------

    def finalize(self, max_width: int = 160, min_log_n: int = 6,
                 copy_chunk: int = 4) -> BuiltCircuit:
        assert not self._finalized
        self._finalized = True
        S = self.S
        G = self.num_gates
        K = len(self.perms)
        arith_rows = -(-G // S) if G else 1

        log_n = min_log_n
        while True:
            n = 1 << log_n
            if n % ROWS_PER_PERMUTATION == 0 and arith_rows <= n:
                blocks = n // ROWS_PER_PERMUTATION
                tiles = -(-K // blocks) if K else 0
                width = 3 * S + T * tiles
                if width <= max_width or log_n >= 22:
                    break
            log_n += 1
        self.log_n, self.n, self.tiles = log_n, n, tiles
        self.p2_base = 3 * S
        num_witness = 3 * S + T * tiles
        num_const = 5 * S + T + p2c.NUM_SELECTORS
        q, wires = self.gate_arrays()

        # every touched cell (flat col * n + row) with its variable, in the
        # JAX package's insertion order: each gate's a, b, c, then each
        # permutation's (input, output) cells lane by lane
        g = np.arange(G, dtype=np.int64)
        row, s = g // S, g % S
        gate_cells = ((3 * s[:, None] + np.arange(3)) * n
                      + row[:, None]).reshape(-1)
        gate_vars = wires.reshape(-1)
        used = gate_vars != _NO
        bpt = n // ROWS_PER_PERMUTATION
        if K:
            ins = np.array([p[0] for p in self.perms], dtype=np.int64)
            outs = np.array([p[1] for p in self.perms], dtype=np.int64)
            k = np.arange(K, dtype=np.int64)
            t, blk = k // bpt, k % bpt
            col = self.p2_base + T * t[:, None] + np.arange(T)
            r0 = (blk * ROWS_PER_PERMUTATION)[:, None]
            perm_cells = np.stack(
                [col * n + r0, col * n + r0 + ROWS_PER_PERMUTATION - 1],
                axis=-1).reshape(-1)
            perm_vars = np.stack([ins, outs], axis=-1).reshape(-1)
        else:
            perm_cells = perm_vars = np.zeros(0, np.int64)
        cells = np.concatenate([gate_cells[used], perm_cells])
        var_of = np.concatenate([gate_vars[used], perm_vars])
        order = np.argsort(var_of, kind="stable")
        cv, cc = var_of[order], cells[order]
        starts = np.r_[0, np.flatnonzero(cv[1:] != cv[:-1]) + 1]
        ends = np.r_[starts[1:], len(cv)]
        # one cycle per multi-cell variable: each cell to the next, the
        # last to the first
        succ = np.roll(cc, -1)
        succ[ends - 1] = cc[starts]
        multi = np.repeat(ends - starts > 1, ends - starts)
        wiring = pk.CopyWiring(cc[multi], succ[multi])

        # const columns
        const = np.zeros((num_const, n), dtype=np.uint64)
        for i in range(5):
            const[5 * s + i, row] = q[:, i]
        block = p2c._block_const_rows().astype(np.uint64)  # (32, 15)
        const[5 * S:] = np.tile(block, (bpt, 1)).T

        # public input cells: canonical (first) cell of each marked var
        pis = []
        first_vars = cv[starts]
        for v in self.pi_vars:
            k = int(np.searchsorted(first_vars, v))
            assert k < len(first_vars) and first_vars[k] == v, \
                f"public var {v} has no constrained cell"
            pis.append(tuple(divmod(int(cc[starts[k]]), n)))

        self._ir_args = (log_n, num_witness, num_const, tuple(pis),
                         copy_chunk)
        ir = self._make_ir(*self._ir_args)
        return BuiltCircuit(ir=ir, const_cols=const, wiring=wiring,
                            layout=self)

    def ir_shape(self) -> Dict:
        """All that the IR of this finalized builder depends on, as plain
        JSON values: `ir_from_shape` makes the same IR from them in another
        process, without the program (a node or the scheduler verifying a
        proof of this circuit needs only its IR)."""
        log_n, num_witness, num_const, pis, copy_chunk = self._ir_args
        return dict(slots=self.S, tiles=self.tiles, log_n=log_n,
                    num_witness=num_witness, num_const=num_const,
                    public_input_cells=[list(c) for c in pis],
                    copy_chunk=copy_chunk)

    def _make_ir(self, log_n, num_witness, num_const, pis, copy_chunk):
        S, tiles, p2_base = self.S, self.tiles, self.p2_base
        diag = get_params()["internal_diag"]

        def eval_plonk_part(alg, w, w_next, c):
            if getattr(alg, "stacks_tiles", False):
                a, b, o = (torch.stack(w[j:3 * S:3]) for j in range(3))
                qm, ql, qr, qo, qc = (torch.stack(c[i:5 * S:5])
                                      for i in range(5))
                v = alg.add(alg.mul(qm, alg.mul(a, b)), alg.mul(ql, a))
                v = alg.add(v, alg.mul(qr, b))
                v = alg.add(v, alg.mul(qo, o))
                v = alg.add(v, qc)
                return [v[s] for s in range(S)]
            out = []
            for s in range(S):
                a, b, o = w[3 * s], w[3 * s + 1], w[3 * s + 2]
                qm, ql, qr, qo, qc = (c[5 * s + i] for i in range(5))
                v = alg.add(alg.mul(qm, alg.mul(a, b)), alg.mul(ql, a))
                v = alg.add(v, alg.mul(qr, b))
                v = alg.add(v, alg.mul(qo, o))
                out.append(alg.add(v, qc))
            return out

        def eval_tiles_part(alg, w, w_next, c):
            rc = [c[5 * S + i] for i in range(T)]
            s_lin, s_ext, s_int = (c[5 * S + T], c[5 * S + T + 1],
                                   c[5 * S + T + 2])
            if getattr(alg, "stacks_tiles", False):
                return _tiles_stacked(w, w_next, rc, (s_lin, s_ext, s_int))
            out = []
            for t in range(tiles):
                base = p2_base + T * t
                state = [w[base + i] for i in range(T)]
                nxt = [w_next[base + i] for i in range(T)]
                lin_out = p2c._external_linear_alg(alg, state)
                sboxed = [p2c._pow7_alg(alg, alg.add(state[i], rc[i]))
                          for i in range(T)]
                ext_out = p2c._external_linear_alg(alg, sboxed)
                s_prime = list(state)
                s_prime[0] = sboxed[0]
                int_out = p2c._internal_linear_alg(alg, s_prime, diag)
                for i in range(T):
                    t1 = alg.mul(s_lin, alg.sub(nxt[i], lin_out[i]))
                    t2 = alg.mul(s_ext, alg.sub(nxt[i], ext_out[i]))
                    t3 = alg.mul(s_int, alg.sub(nxt[i], int_out[i]))
                    out.append(alg.add(alg.add(t1, t2), t3))
            return out

        def _tiles_stacked(w, w_next, rc, sel):
            """Every tile's 12 transition constraints at once, on
            (tiles, n, 12) states; the values and order of the list path."""
            cols = slice(p2_base, p2_base + T * tiles)

            def states(ws):
                x = torch.stack(ws[cols])
                return x.reshape(tiles, T, -1).transpose(1, 2).contiguous()

            state, nxt = states(w), states(w_next)
            rcs = torch.stack(rc).t().contiguous()            # (n, 12)
            diag_t = gl.from_u64(const_tables_u64()[2], state.device)
            sboxed = gl.pow7(gl.add(state, rcs))
            lin_out = rpc._external_linear(state)
            ext_out = rpc._external_linear(sboxed)
            int_out = rpc._internal_linear(
                torch.cat([sboxed[..., :1], state[..., 1:]], dim=-1), diag_t)
            s_lin, s_ext, s_int = (x.reshape(-1, 1) for x in sel)
            v = gl.add(gl.add(gl.mul(s_lin, gl.sub(nxt, lin_out)),
                              gl.mul(s_ext, gl.sub(nxt, ext_out))),
                       gl.mul(s_int, gl.sub(nxt, int_out)))
            return [v[t, :, i] for t in range(tiles) for i in range(T)]

        def eval_gates(alg, w, w_next, c):
            out = eval_plonk_part(alg, w, w_next, c)
            if tiles:
                out += eval_tiles_part(alg, w, w_next, c)
            return out

        # degree stratification (prover-only, proofs bit-identical): the
        # PLONK slot constraints are degree 3, the Poseidon2 tile rounds
        # degree 8 (selector * x^7)
        parts = ((eval_plonk_part, eval_tiles_part) if tiles
                 else (eval_plonk_part,))
        counts = ((S, T * tiles) if tiles else (S,))
        degs = ((3, 8) if tiles else (3,))
        cols = ((tuple(range(3 * S)),
                 tuple(range(p2_base, p2_base + T * tiles))) if tiles
                else (tuple(range(3 * S)),))
        return pk.PlonkishIR(
            log_n=log_n, num_witness=num_witness, num_const=num_const,
            gate_degree=8 if tiles else 3,
            num_gate_constraints=S + T * tiles,
            eval_gates=eval_gates, copy_chunk=copy_chunk,
            public_input_cells=pis,
            eval_gates_parts=parts, gate_part_counts=counts,
            gate_part_degrees=degs, gate_part_cols=cols)

    @classmethod
    def ir_from_shape(cls, shape: Dict) -> pk.PlonkishIR:
        """The IR of a finalized builder from its `ir_shape()`."""
        b = cls(slots=shape["slots"])
        b.tiles, b.p2_base = shape["tiles"], 3 * shape["slots"]
        return b._make_ir(shape["log_n"], shape["num_witness"],
                          shape["num_const"],
                          tuple(tuple(c) for c in
                                shape["public_input_cells"]),
                          shape["copy_chunk"])

    # -- witness evaluation ------------------------------------------------

    def _schedule(self):
        """The op list in rounds: round L holds the non-permutation ops of
        level L in program order, then the permutations whose inputs reach
        level L at most, whose outputs are of level L + 1 (an input, a
        constant: level 0; any other op: its operands' highest level). Every
        operand of a round's op is computed in an earlier round or earlier
        in its own, so the rounds give the sequential evaluation's values,
        and a round's permutations are independent of each other."""
        if self._rounds is not None:
            return self._rounds
        lvl = array("l", bytes(8 * self.n_vars))
        ops_at: List[List[Tuple]] = [[]]
        perms_at: List[List[Tuple]] = [[]]
        # the loop runs once per op of circuits of tens of millions of
        # them: two-way maxima as comparisons, not calls of max()
        for op in self.ops:
            kind = op[0]
            if kind <= _MUL:  # _ADD, _SUB, _MUL (after _INPUT, _CONST)
                if kind <= _CONST:
                    L = 0
                else:
                    a, b = lvl[op[2]], lvl[op[3]]
                    L = a if a > b else b
            elif kind == _LIN:
                L = lvl[op[3]]
                if op[5] != _NO:
                    b = lvl[op[5]]
                    L = L if L > b else b
            elif kind == _PERM:
                _, outs, ins = op
                L = max(lvl[i] for i in ins)
                for o in outs:
                    lvl[o] = L + 1
                while len(perms_at) <= L + 1:
                    perms_at.append([])
                    ops_at.append([])
                perms_at[L].append(op)
                continue
            else:  # _HINT
                L = max((lvl[d] for d in op[3]), default=0)
            lvl[op[1]] = L
            ops_at[L].append(op)
        self._rounds = list(zip(ops_at, perms_at))
        return self._rounds

    def eval_values(self, assignments: Dict[int, int],
                    device=None) -> List[int]:
        """Evaluate the op list on exact ints; `assignments` maps input vars
        to values. On a CUDA `device` the permutations of each round of
        `_schedule` go to the card as one batch; on the CPU each is permuted
        in Python ints. `device=None` means the CUDA card (raises where there
        is none)."""
        device = gl.resolve_device(device)
        vals: List[Optional[int]] = [None] * self.n_vars
        for ops, perms in self._schedule():
            for op in ops:
                kind = op[0]
                if kind == _MUL:
                    vals[op[1]] = (vals[op[2]] * vals[op[3]]) % P
                elif kind == _LIN:
                    _, z, ax, x, by, y, cc = op
                    acc = (ax * vals[x] + cc) % P
                    if y != _NO:
                        acc = (acc + by * vals[y]) % P
                    vals[z] = acc
                elif kind == _ADD:
                    vals[op[1]] = (vals[op[2]] + vals[op[3]]) % P
                elif kind == _SUB:
                    vals[op[1]] = (vals[op[2]] - vals[op[3]]) % P
                elif kind == _INPUT:
                    vals[op[1]] = int(assignments[op[1]]) % P
                elif kind == _CONST:
                    vals[op[1]] = op[2]
                elif kind == _HINT:
                    _, v, fn, deps = op
                    vals[v] = int(fn(*(vals[d] for d in deps))) % P
                else:  # pragma: no cover
                    raise ValueError(kind)
            if perms:
                states = [[vals[i] for i in op[2]] for op in perms]
                for op, out in zip(perms, _permute_batch(states, device)):
                    for o, x in zip(op[1], out):
                        vals[o] = x
        return [v if v is not None else 0 for v in vals]

    def fill_witness(self, assignments: Dict[int, int],
                     device=None) -> gl.GF:
        """The (width, n) witness of these input values on `device`
        (`None` means the CUDA card, raises where there is none)."""
        assert self._finalized
        device = gl.resolve_device(device)
        vals = np.array(self.eval_values(assignments, device),
                        dtype=np.uint64)
        return self._witness_from_values(vals, device)

    def _witness_from_values(self, vals: np.ndarray, device) -> gl.GF:
        S, n = self.S, self.n
        _, wires = self.gate_arrays()
        arith = np.zeros((3 * S, n), dtype=np.uint64)
        g = np.arange(len(wires), dtype=np.int64)
        for j in range(3):
            used = wires[:, j] != _NO
            arith[3 * (g[used] % S) + j, g[used] // S] = vals[wires[used, j]]
        W = gl.from_u64(arith, device)
        if not self.tiles:
            return W
        bpt = n // ROWS_PER_PERMUTATION
        inputs = np.zeros((self.tiles * bpt, T), dtype=np.uint64)
        if self.perms:
            ins = np.array([p[0] for p in self.perms], dtype=np.int64)
            inputs[:len(self.perms)] = vals[ins]
        rows = rpc._block_rows_device(gl.from_u64(inputs, device))
        tiles = rows.reshape(self.tiles, n, T).transpose(1, 2)
        return torch.cat([W, tiles.reshape(self.tiles * T, n)])

    def ir_width(self) -> int:
        return 3 * self.S + T * self.tiles

    def public_values(self, assignments: Dict[int, int],
                      device=None) -> List[int]:
        vals = self.eval_values(assignments, device)
        return [vals[v] for v in self.pi_vars]

    def unsatisfied_gates(self, vals: Sequence[int], device=None
                          ) -> np.ndarray:
        """Indices of the arithmetic gates that `vals` (the values of
        `eval_values`) do not satisfy, evaluated with the field kernels on
        `device`: the gate part of a satisfiability check of the filled
        witness. The permutation tiles and the copy cycles hold by
        construction of `fill_witness`."""
        device = gl.resolve_device(device)
        q, wires = self.gate_arrays()
        vals = np.asarray(vals, dtype=np.uint64)
        ab = np.where(wires >= 0, vals[np.maximum(wires, 0)], np.uint64(0))
        a, b, c = (gl.from_u64(ab[:, j], device) for j in range(3))
        qm, ql, qr, qo, qc = (gl.from_u64(q[:, i], device) for i in range(5))
        v = gl.add(gl.mul(qm, gl.mul(a, b)), gl.mul(ql, a))
        v = gl.add(gl.add(v, gl.mul(qr, b)), gl.add(gl.mul(qo, c), qc))
        return np.flatnonzero(gl.to_u64(v) != 0)


def _permute_batch(states: List[List[int]], device) -> List[List[int]]:
    """Independent 12-lane states of canonical ints, each permuted: on a
    CUDA device in one launch of the Poseidon2 kernel, on the CPU one at a
    time in exact Python ints (the plain tensor version costs thousands of
    tensor ops a call)."""
    if device.type != "cuda":
        return [ck.poseidon2_permute_ints(x) for x in states]
    u = np.array(states, dtype=np.uint64)
    out = ck.poseidon2_permute(gl.from_u64(u, device))
    return gl.to_u64(out).tolist()


# -- extension-field helpers over builder vars ------------------------------

EVar = Tuple[int, int]  # (c0 var, c1 var)
W_EXT = 7


class ExtOps:
    """GF(p^2) ops (x^2 = 7, utils/field_int.py convention) lowered to
    builder slots."""

    def __init__(self, bld: CircuitBuilder):
        self.b = bld

    def const(self, pair) -> EVar:
        return (self.b.constant(pair[0]), self.b.constant(pair[1]))

    def add(self, x: EVar, y: EVar) -> EVar:
        return (self.b.add(x[0], y[0]), self.b.add(x[1], y[1]))

    def sub(self, x: EVar, y: EVar) -> EVar:
        return (self.b.sub(x[0], y[0]), self.b.sub(x[1], y[1]))

    def mul(self, x: EVar, y: EVar) -> EVar:
        b = self.b
        m0 = b.mul(x[0], y[0])
        m1 = b.mul(x[1], y[1])
        m2 = b.mul(x[0], y[1])
        m3 = b.mul(x[1], y[0])
        c0 = b.lin(1, m0, W_EXT, m1)
        c1 = b.add(m2, m3)
        return (c0, c1)

    def mul_base(self, x: EVar, s: int) -> EVar:
        """x * s with s a base-field VAR."""
        return (self.b.mul(x[0], s), self.b.mul(x[1], s))

    def scale_int(self, x: EVar, c: int) -> EVar:
        return (self.b.mul_int(x[0], c), self.b.mul_int(x[1], c))

    def from_base(self, v: int) -> EVar:
        return (v, self.b.zero)

    def inverse(self, x: EVar) -> EVar:
        """Provided ext inverse: inv with x*inv == 1 enforced."""
        b = self.b
        i0 = b.hint(lambda a0, a1: _einv_host(a0, a1)[0], (x[0], x[1]))
        i1 = b.hint(lambda a0, a1: _einv_host(a0, a1)[1], (x[0], x[1]))
        prod = self.mul(x, (i0, i1))
        b.assert_one(prod[0])
        b.assert_zero(prod[1])
        return (i0, i1)

    def assert_eq(self, x: EVar, y: EVar):
        self.b.assert_eq(x[0], y[0])
        self.b.assert_eq(x[1], y[1])

    def mux(self, bit: int, x: EVar, y: EVar) -> EVar:
        return (self.b.mux(bit, x[0], y[0]), self.b.mux(bit, x[1], y[1]))


def _einv_host(a0: int, a1: int) -> Tuple[int, int]:
    norm = (a0 * a0 - W_EXT * a1 * a1) % P
    ninv = pow(norm, P - 2, P)
    return (a0 * ninv) % P, (-a1 * ninv) % P
