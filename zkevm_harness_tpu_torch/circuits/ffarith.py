"""Foreign-field arithmetic circuit core: non-native modmul rows.

The reference implements ecrecover and the EIP-4844 equivalence check with
boojum's non-native field gadgets (u16 limbs + range tables;
zkevm_circuits ecrecover/eip4844 over secp256k1 / BLS12-381-Fr). This is
the counterpart on the PLONKish engine: a row-per-operation circuit where
every active row enforces ONE fused operation over a foreign modulus M (up
to 256 bits)

    R = (A * B + C) mod M

in L-bit limb arithmetic, exactly over the integers:

  - witness regions A, B, C, Q, R of NL limbs each; the defining identity
    A*B + C - Q*M - R = 0 is checked digit-by-digit with an offset-carry
    chain (carries are witnessed SHIFTED by 2*NL*2^L so they are always
    nonnegative, then split into two L-bit limbs);
  - every limb column (A,B,C,Q,R and both carry halves) is range-checked
    to [0, 2^L) through the engine's logup lookup argument — the same
    specialized-lookup shape the reference uses for its u16 limbs;
  - operands chain between rows through the copy-permutation argument
    (R limbs of one row copy-wired into A/B/C limbs of later rows), so a
    multi-op program (an inverse check, a barycentric sum, a point add)
    is just a sequence of rows;
  - per-row constant operands live in NL-wide const-column regions gated
    by selectors, so they cost zero witness columns.

All constraint values stay far below the Goldilocks modulus
(max ~ NL * 2^(2L) + 2^(3L) << 2^64 for L=16, NL=16), so the digit
identities are exact integer statements and the telescoped sum forces
A*B + C = Q*M + R over Z.

Counterpart of the JAX package's `circuits/ffarith.py`. The port's
differences, none in what is computed:
  - on the device algebra (`stacks_tiles`) the digit identities are
    evaluated with the limbs stacked: one (NL, n) product per A limb and
    per Q limb, accumulated into the (2NL - 1, n) digits, and the pinning
    constraints as (NL, n) blocks; the values come out in the JAX
    package's order (the host algebras run its loops);
  - the layout's copy permutation is a `plonkish.CopyWiring` of the moved
    cells, built from the same cycles in the same order (members in
    insertion order, limb by limb), without the dense (width, n, 2) array;
  - the constant rows are uint64 numpy;
  - `ff_witness` computes the row values (each a bigint a*b + c split by
    divmod by M) in one Python pass, in program order, since operands are
    earlier rows' results; the limbs, digits and carries of all rows then
    follow at once in numpy int64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from .keccak_circuit import col_stack, rows_of, stacks

P = gl.P


@dataclasses.dataclass(frozen=True)
class FFParams:
    modulus: int
    limb_bits: int = 16
    num_limbs: int = 16

    @property
    def shift(self) -> int:
        # >= max |true carry| = 2*NL*2^L; shifted carries fit 2 limbs
        return 2 * self.num_limbs * (1 << self.limb_bits)

    def split(self, v: int) -> List[int]:
        L, NL = self.limb_bits, self.num_limbs
        return [(int(v) >> (L * i)) & ((1 << L) - 1) for i in range(NL)]

    def join(self, limbs: Sequence[int]) -> int:
        L = self.limb_bits
        return sum(int(x) << (L * i) for i, x in enumerate(limbs))

    def split_many(self, values: Sequence[int]) -> np.ndarray:
        """(len(values), NL) int64 limbs of nonnegative ints < 2^(NL*L)."""
        L, NL = self.limb_bits, self.num_limbs
        if L in (8, 16, 32):
            width = NL * L // 8
            buf = b"".join(int(v).to_bytes(width, "little") for v in values)
            dt = {8: "<u1", 16: "<u2", 32: "<u4"}[L]
            return np.frombuffer(buf, dtype=dt).astype(np.int64).reshape(
                len(values), NL)
        return np.array([self.split(v) for v in values],
                        dtype=np.int64).reshape(len(values), NL)


# column regions per row
def _regions(NL: int, bind_c: bool = False) -> Dict[str, int]:
    ncar = 2 * NL - 1
    off = {}
    off["A"] = 0
    off["B"] = NL
    off["C"] = 2 * NL
    off["Q"] = 3 * NL
    off["R"] = 4 * NL
    off["CLO"] = 5 * NL
    off["CHI"] = 5 * NL + ncar
    w = 5 * NL + 2 * ncar
    if bind_c:
        # binding fingerprint over flagged rows' C operands: NL challenge
        # powers + gamma + accumulator (challenge-after-commit, the same
        # discipline as every sorter/precompile circuit)
        off["FPCH"] = w
        off["FGAMMA"] = w + NL
        off["FACC"] = w + NL + 1
        w += NL + 2
    off["_width"] = w
    return off


# const columns: selectors s_mul, s_cb (B from const), s_cc (C from
# const), s_rc (R pinned to const), then NL-wide B/C/R const limb regions
K_SM, K_CB, K_CC, K_RC = 0, 1, 2, 3
K_BCONST = 4


@dataclasses.dataclass
class FFVar:
    """A foreign-field value: the row/region its limbs live in."""
    row: int
    region: str  # "A"|"B"|"C"|"R"


class FFProgram:
    """Records rows of (a, b, c) -> r = (a*b + c) mod M with copy wiring.

    Each op consumes FFVars (or None for zero C / int for constants routed
    through const columns) and returns the result FFVar (the row's R
    region)."""

    def __init__(self, params: FFParams):
        self.p = params
        self.rows: List[dict] = []
        self.aliases: List[Tuple[FFVar, FFVar]] = []  # equality constraints

    def assert_eq(self, x: "FFVar", y: "FFVar"):
        """Constrain two values equal by merging their copy cycles."""
        self.aliases.append((x, y))

    def boolean(self) -> FFVar:
        """A fresh boolean: row R = A*A with B copy-wired to A and R
        aliased back to A, forcing A = A^2. Assign inputs[(row, "A")]."""
        row = len(self.rows)
        a_self = FFVar(row, "A")
        self._op(None, a_self, None)
        self.assert_eq(FFVar(row, "R"), a_self)
        return a_self

    def _op(self, a, b, c, b_const: Optional[int] = None,
            c_const: Optional[int] = None, a_hint=None,
            fp: bool = False) -> FFVar:
        row = len(self.rows)
        self.rows.append(dict(a=a, b=b, c=c, b_const=b_const,
                              c_const=c_const, a_hint=a_hint, fp=fp))
        return FFVar(row, "R")

    def input(self) -> FFVar:
        """A fresh input value: one row computing R = A*1 + 0 (so A is the
        free input, R its mod-M representative that every use site wires
        from — reuse is sound because all uses join R's copy cycle).
        Assign the value as inputs[(row, "A")] at witness time."""
        return self._op(None, None, None, b_const=1)

    def zero(self) -> FFVar:
        """A pinned-zero value (0*A + 0)."""
        return self._op(None, None, None, b_const=0)

    def mul(self, a: FFVar, b: FFVar) -> FFVar:
        return self._op(a, b, None)

    def mul_const(self, a: FFVar, b_const: int) -> FFVar:
        return self._op(a, None, None, b_const=b_const % self.p.modulus)

    def fma(self, a: FFVar, b: FFVar, c: FFVar) -> FFVar:
        return self._op(a, b, c)

    def fma_bound(self, a: Optional[FFVar], b: Optional[FFVar],
                  b_const: Optional[int] = None) -> FFVar:
        """R = a*b + C where C is a FREE input bound by the circuit's
        binding-fingerprint accumulator (requires bind_c layouts). Assign
        the C value as inputs[(row, "C")] at witness time."""
        return self._op(a, b, None, b_const=b_const, fp=True)

    def fma_const(self, a: FFVar, b_const: int, c: FFVar) -> FFVar:
        return self._op(a, None, c, b_const=b_const % self.p.modulus)

    def add(self, a: FFVar, c: FFVar) -> FFVar:
        # a*1 + c
        return self._op(a, None, c, b_const=1)

    def add_const(self, a: FFVar, c_const: int) -> FFVar:
        return self._op(a, None, None, b_const=1,
                        c_const=c_const % self.p.modulus)

    def inverse(self, x: FFVar) -> FFVar:
        """Witness the inverse, enforce x*inv mod M == 1 by pinning the
        result row's R to the constant 1 (R-const selector reuses the
        C-const columns on a dedicated check row)."""
        self._op(None, x, None,
                 a_hint=lambda xv: pow(xv, self.p.modulus - 2,
                                       self.p.modulus))
        # check row: inv * x + 0 == 1  -> R pinned to const 1
        self.rows[-1]["r_const"] = 1
        return FFVar(len(self.rows) - 1, "A")  # the inverse value itself


def _conv_sizes(NL: int) -> int:
    return 2 * NL - 1


def _digit_gates_stacked(alg, w, c, params: FFParams, off, s_m) -> List:
    """The 2NL - 1 digit identities and the final carry, stacked."""
    NL, L = params.num_limbs, params.limb_bits
    ncar = _conv_sizes(NL)
    A = col_stack(w, off["A"], NL)
    B = col_stack(w, off["B"], NL)
    C = col_stack(w, off["C"], NL)
    Q = col_stack(w, off["Q"], NL)
    R = col_stack(w, off["R"], NL)
    car = alg.add(col_stack(w, off["CLO"], ncar),
                  alg.mul_int(col_stack(w, off["CHI"], ncar), 1 << L))
    neg_m = gl.from_int([(P - m) % P for m in params.split(params.modulus)],
                        A.device).reshape(NL, 1)
    # pairs (A_i, B) and (Q_i, -M) stacked, so that digit block i..i+NL-1
    # gains both products in one multiply
    BM = torch.stack([B, neg_m.expand_as(B)])                  # (2, NL, n)
    D = torch.zeros((ncar,) + A.shape[1:], dtype=torch.int64,
                    device=A.device)
    for i in range(NL):
        AQ = torch.stack([A[i], Q[i]]).unsqueeze(1)            # (2, 1, n)
        prod = alg.mul(AQ, BM)
        D[i:i + NL] = alg.add(D[i:i + NL], alg.add(prod[0], prod[1]))
    D[:NL] = alg.add(D[:NL], alg.sub(C, R))
    car_s = alg.add_int(car, P - params.shift)                  # car - SHIFT
    D[1:] = alg.add(D[1:], car_s[:-1])
    D = alg.sub(D, alg.mul_int(car_s, 1 << L))
    return rows_of(alg.mul(s_m, D)) + [alg.mul(s_m, car_s[ncar - 1])]


def ff_ir(params: FFParams, log_n: int, num_rows: int,
          bind_c: bool = False) -> pk.PlonkishIR:
    """IR for a program of `num_rows` active op rows (padded to 2^log_n)."""
    NL, L = params.num_limbs, params.limb_bits
    off = _regions(NL, bind_c)
    width = off["_width"]
    M_limbs = params.split(params.modulus)
    SHIFT = params.shift
    ncar = _conv_sizes(NL)
    num_const = K_BCONST + 3 * NL + (2 if bind_c else 0)
    K_FP = K_BCONST + 3 * NL       # fp-row selector
    K_FW = K_FP + 1                # wrap-row marker

    def eval_gates(alg, w, w_next, c):
        out = []
        s_m, s_cb, s_cc = c[K_SM], c[K_CB], c[K_CC]
        s_rc = c[K_RC]

        if stacks(alg):
            out += _digit_gates_stacked(alg, w, c, params, off, s_m)
            pins = [alg.mul(s, alg.sub(col_stack(w, off[reg], NL),
                                       col_stack(c, K_BCONST + k * NL, NL)))
                    for k, (s, reg) in enumerate(((s_cb, "B"), (s_cc, "C"),
                                                  (s_rc, "R")))]
            out += rows_of(torch.stack(pins, dim=1))
        else:
            A = [w[off["A"] + i] for i in range(NL)]
            B = [w[off["B"] + i] for i in range(NL)]
            C = [w[off["C"] + i] for i in range(NL)]
            Q = [w[off["Q"] + i] for i in range(NL)]
            R = [w[off["R"] + i] for i in range(NL)]
            CLO = [w[off["CLO"] + k] for k in range(ncar)]
            CHI = [w[off["CHI"] + k] for k in range(ncar)]

            # digit identities with offset carries (gated by s_mul)
            for k in range(ncar):
                d = None

                def acc(d, t):
                    return t if d is None else alg.add(d, t)

                for i in range(max(0, k - NL + 1), min(NL, k + 1)):
                    j = k - i
                    d = acc(d, alg.mul(A[i], B[j]))
                    if M_limbs[j]:
                        d = acc(d, alg.mul_int(Q[i], P - M_limbs[j]))
                if k < NL:
                    d = acc(d, C[k])
                    d = acc(d, alg.mul_int(R[k], P - 1))
                car_k = alg.add(CLO[k], alg.mul_int(CHI[k], 1 << L))
                if k > 0:
                    car_prev = alg.add(CLO[k - 1],
                                       alg.mul_int(CHI[k - 1], 1 << L))
                    d = acc(d, alg.add_int(car_prev, P - SHIFT))
                # d - (car_k - SHIFT)*2^L == 0
                d = acc(d, alg.mul_int(alg.add_int(car_k, P - SHIFT),
                                       P - (1 << L)))
                out.append(alg.mul(s_m, d))
            # final carry returns to SHIFT
            car_last = alg.add(CLO[ncar - 1],
                               alg.mul_int(CHI[ncar - 1], 1 << L))
            out.append(alg.mul(s_m, alg.add_int(car_last, P - SHIFT)))

            # const-operand pinning
            for i in range(NL):
                out.append(alg.mul(s_cb, alg.sub(B[i], c[K_BCONST + i])))
                out.append(alg.mul(s_cc, alg.sub(C[i],
                                                 c[K_BCONST + NL + i])))
                out.append(alg.mul(s_rc, alg.sub(R[i],
                                                 c[K_BCONST + 2 * NL + i])))

        if bind_c:
            C = [w[off["C"] + i] for i in range(NL)]
            s_fp, s_fw = c[K_FP], c[K_FW]
            pch = [w[off["FPCH"] + j] for j in range(NL)]
            gamma = w[off["FGAMMA"]]
            acc = w[off["FACC"]]
            acc_n = w_next[off["FACC"]]
            out.append(alg.sub(w_next[off["FGAMMA"]], gamma))
            for j in range(NL):
                out.append(alg.sub(w_next[off["FPCH"] + j], pch[j]))
            for j in range(NL - 1):
                out.append(alg.mul(s_fp, alg.sub(pch[j + 1],
                                                 alg.mul(pch[j], pch[0]))))
            # ORDER-SENSITIVE Horner fingerprint: acc' = acc*gamma + fp(C)
            t = None
            for j in range(NL):
                term = alg.mul(pch[j], C[j])
                t = term if t is None else alg.add(t, term)
            out.append(alg.mul(s_fp, alg.sub(
                acc_n, alg.add(alg.mul(acc, gamma), t))))
            # carried outside fp rows (wrap row excluded)
            gate = alg.sub(alg.add_int(alg.mul_int(s_fp, P - 1), 1),
                           s_fw)  # 1 - s_fp - s_fw
            out.append(alg.mul(gate, alg.sub(acc_n, acc)))
        return out

    n_constraints = (ncar + 1 + 3 * NL
                     + ((1 + NL + NL - 1 + 2) if bind_c else 0))

    # one range table; every LIMB column looked up (the binding fingerprint
    # columns hold full field elements and are excluded)
    table = np.arange(1 << L, dtype=object).reshape(-1, 1)
    n_limb_cols = 5 * NL + 2 * ncar
    sets = tuple((0, (j,)) for j in range(n_limb_cols))

    return pk.PlonkishIR(
        log_n=log_n, num_witness=width, num_const=num_const,
        gate_degree=4 if bind_c else 3,
        num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=(),
        lookup_tables=(table,), lookup_sets=sets)


@dataclasses.dataclass
class FFLayout:
    params: FFParams
    log_n: int
    num_rows: int
    const_rows: np.ndarray      # (n, num_const) uint64
    wiring: pk.CopyWiring
    program: FFProgram
    pi_cells: Tuple = ()
    bind_c: bool = False


def _copy_cycles(prog: FFProgram, off: Dict[str, int]
                 ) -> List[List[Tuple[int, int]]]:
    """The copy cycles of the program's values, each as its base cells
    (region column offset, row), limb 0: a value's defining cells (union-find
    over the aliases), then its use sites, in the JAX package's order."""
    parent: Dict[Tuple[int, str], Tuple[int, str]] = {}

    def find(k):
        parent.setdefault(k, k)
        while parent[k] != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    for (x, y) in prog.aliases:
        parent[find((x.row, x.region))] = find((y.row, y.region))

    sites: Dict[Tuple[int, str], List[Tuple[str, int]]] = {}

    def use(var: Optional[FFVar], region: str, row: int):
        if var is None:
            return
        sites.setdefault(find((var.row, var.region)), []).append((region, row))

    for r, row in enumerate(prog.rows):
        use(row["a"], "A", r)
        use(row["b"], "B", r)
        use(row["c"], "C", r)

    # group defining cells per union-find root
    members: Dict[Tuple[int, str], List[Tuple[int, str]]] = {}
    seen = set()
    for (x, y) in prog.aliases:
        for v in ((x.row, x.region), (y.row, y.region)):
            if v not in seen:
                seen.add(v)
                members.setdefault(find(v), []).append(v)
    for key in list(sites.keys()):
        if key not in seen:
            members.setdefault(key, []).append(key)
            seen.add(key)

    cycles = []
    for root, defs in members.items():
        uses = sites.get(root, [])
        if len(defs) == 1 and not uses:
            continue
        cycles.append([(off[dreg], drow) for (drow, dreg) in defs]
                      + [(off[reg], urow) for (reg, urow) in uses])
    return cycles


def _wiring_from_cycles(cycles: List[List[Tuple[int, int]]], NL: int,
                        n: int) -> pk.CopyWiring:
    """The successors the JAX package writes into its dense permutation,
    cycle by cycle and limb by limb (cell k -> cell k + 1 of the cycle's
    limb-i cells, the last back to the first); a cell written twice keeps
    the later successor, as there."""
    if not cycles:
        return pk.CopyWiring.identity()
    lens = np.array([len(cy) for cy in cycles], dtype=np.int64)
    flat = np.array([cell for cy in cycles for cell in cy], dtype=np.int64)
    cols, rows = flat[:, 0], flat[:, 1]
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    pos = np.arange(len(flat)) - np.repeat(starts, lens)
    nxt = np.repeat(starts, lens) + (pos + 1) % np.repeat(lens, lens)
    cyc = np.repeat(np.arange(len(cycles)), lens)
    limb = np.arange(NL, dtype=np.int64)[:, None]
    cells = ((cols[None, :] + limb) * n + rows[None, :])
    succ = ((cols[nxt][None, :] + limb) * n + rows[nxt][None, :])
    # write order of the JAX loops: cycle, then limb, then cell
    order = np.lexsort((np.broadcast_to(np.arange(len(flat)), cells.shape)
                        .ravel(),
                        np.broadcast_to(limb, cells.shape).ravel(),
                        np.broadcast_to(cyc, cells.shape).ravel()))
    cells, succ = cells.ravel()[order], succ.ravel()[order]
    # the last write of a cell wins
    uniq, first_rev = np.unique(cells[::-1], return_index=True)
    last = len(cells) - 1 - first_rev
    cells, succ = uniq, succ[last]
    moved = succ != cells
    return pk.CopyWiring(cells[moved], succ[moved])


def build_ff_layout(prog: FFProgram, min_log_n: int = 4,
                    public_results: Sequence[FFVar] = ()) -> FFLayout:
    """Lay the program onto rows: const columns from per-row constants,
    copy wiring from operand wiring, PI cells from public results
    (prefixed by the binding-fingerprint PIs when the program has
    fp-flagged rows)."""
    p = prog.p
    NL = p.num_limbs
    bind_c = any(row.get("fp") for row in prog.rows)
    off = _regions(NL, bind_c)
    num_rows = len(prog.rows)
    log_n = min_log_n
    # the range table needs 2^L rows in the trace domain
    while (1 << log_n) < max(num_rows, 1 << p.limb_bits):
        log_n += 1
    n = 1 << log_n

    K_FP = K_BCONST + 3 * NL
    K_FW = K_FP + 1
    const = np.zeros((n, K_BCONST + 3 * NL + (2 if bind_c else 0)),
                     dtype=np.uint64)
    limbs_of: Dict[int, np.ndarray] = {}

    def limbs(v: int) -> np.ndarray:
        if v not in limbs_of:
            limbs_of[v] = np.array(p.split(v), dtype=np.uint64)
        return limbs_of[v]

    for r, row in enumerate(prog.rows):
        const[r, K_SM] = 1
        if row["b_const"] is not None:
            const[r, K_CB] = 1
            const[r, K_BCONST:K_BCONST + NL] = limbs(row["b_const"])
        if (row["c"] is None and row["c_const"] is None
                and not row.get("fp")):
            row["c_const"] = 0  # pin free addends to zero
        if row["c_const"] is not None:
            const[r, K_CC] = 1
            const[r, K_BCONST + NL:K_BCONST + 2 * NL] = limbs(row["c_const"])
        if row.get("r_const") is not None:
            const[r, K_RC] = 1
            const[r, K_BCONST + 2 * NL:K_BCONST + 3 * NL] = \
                limbs(row["r_const"])
        if row.get("fp"):
            const[r, K_FP] = 1
    if bind_c:
        const[n - 1, K_FW] = 1

    wiring = _wiring_from_cycles(_copy_cycles(prog, off), NL, n)

    pis = []
    if bind_c:
        pis += [(off["FPCH"], 0), (off["FGAMMA"], 0),
                (off["FACC"], 0), (off["FACC"], n - 1)]
    for var in public_results:
        for i in range(NL):
            pis.append((off[var.region] + i, var.row))

    return FFLayout(params=p, log_n=log_n, num_rows=num_rows,
                    const_rows=const, wiring=wiring, program=prog,
                    pi_cells=tuple(pis), bind_c=bind_c)


def layout_ir(layout: FFLayout) -> pk.PlonkishIR:
    """The IR of a laid-out program, its public inputs the layout's."""
    ir = ff_ir(layout.params, layout.log_n, layout.num_rows,
               bind_c=layout.bind_c)
    return dataclasses.replace(ir, public_input_cells=layout.pi_cells)


def ff_setup(layout: FFLayout, cfg: pk.PlonkishConfig, device=None
             ) -> Tuple[pk.PlonkishIR, pk.PlonkishSetup]:
    """`device=None` means the CUDA card (raises where there is none)."""
    ir = layout_ir(layout)
    setup = pk.build_setup(ir, layout.const_rows.T, layout.wiring, cfg,
                           device=device)
    return ir, setup


def binding_accumulator(params: FFParams, challenge: int, gamma: int,
                        c_values: Sequence[int], acc_in: int = 1) -> int:
    """Host-side ORDER-SENSITIVE fingerprint over fp-row C operands
    (Horner in gamma, limbs weighted by challenge powers), matching the
    circuit's accumulator chain."""
    acc = int(acc_in) % P
    ch, gm = int(challenge) % P, int(gamma) % P
    for v in c_values:
        t = 0
        pw = ch
        for limb in params.split(int(v)):
            t = (t + pw * limb) % P
            pw = pw * ch % P
        acc = (acc * gm + t) % P
    return acc


def _row_values(layout: FFLayout, inputs: Dict[Tuple[int, str], int]):
    """(a, b, c, q, r) of every program row as Python ints, in program
    order (an operand is an earlier row's result)."""
    p = layout.params
    NL, L = p.num_limbs, p.limb_bits
    M = p.modulus
    values: Dict[Tuple[int, str], int] = {}

    def val_of(var: Optional[FFVar], region: str, row: int,
               const_v: Optional[int]) -> int:
        if const_v is not None:
            return const_v % M
        if var is not None:
            return values[(var.row, var.region)]
        return inputs.get((row, region), 0)

    out = []
    for r, row in enumerate(layout.program.rows):
        if row["a_hint"] is not None:
            bv = val_of(row["b"], "B", r, row["b_const"])
            av = row["a_hint"](bv) % M
        else:
            av = val_of(row["a"], "A", r, None)
        values[(r, "A")] = av  # before B so self-referencing rows resolve
        bv = val_of(row["b"], "B", r, row["b_const"])
        cv = val_of(row["c"], "C", r, row["c_const"])
        qv, rv = divmod(av * bv + cv, M)
        assert qv < (1 << (NL * L)), "quotient overflows limb budget"
        if row.get("r_const") is not None:
            assert rv == row["r_const"] % M, (
                f"row {r}: result {rv:#x} != pinned const "
                f"{row['r_const']:#x} — the witness does not satisfy the "
                f"program's fixed-result check")
        values[(r, "B")] = bv
        values[(r, "C")] = cv
        values[(r, "R")] = rv
        out.append((av, bv, cv, qv, rv))
    return out


def ff_witness(layout: FFLayout, ir: pk.PlonkishIR,
               inputs: Dict[Tuple[int, str], int],
               binding: Optional[Tuple[int, int]] = None,
               device=None) -> gl.GF:
    """Evaluate the program on concrete values. `inputs` assigns integers
    to (row, region) operand slots that are NOT wired from earlier results
    (free A/B/C operands). `binding` = (challenge, gamma) fills the
    fingerprint columns for fp-flagged rows. `device=None` means the CUDA
    card."""
    device = gl.resolve_device(device)
    p = layout.params
    NL, L = p.num_limbs, p.limb_bits
    off = _regions(NL, layout.bind_c)
    n = 1 << layout.log_n
    ncar = _conv_sizes(NL)
    rows = layout.program.rows
    nr = len(rows)
    W = np.zeros((ir.num_witness, n), dtype=np.uint64)

    vals = _row_values(layout, inputs)
    limbs = {reg: p.split_many([v[k] for v in vals])
             for k, reg in enumerate("ABCQR")}
    # digits of A*B - Q*M + C - R, then the carry chain, for all rows
    m_l = np.array(p.split(p.modulus), dtype=np.int64)
    D = np.zeros((nr, ncar), dtype=np.int64)
    for i in range(NL):
        D[:, i:i + NL] += (limbs["A"][:, i:i + 1] * limbs["B"]
                           - limbs["Q"][:, i:i + 1] * m_l[None, :])
    D[:, :NL] += limbs["C"] - limbs["R"]
    car = np.zeros(nr, dtype=np.int64)
    shifted = np.zeros((nr, ncar), dtype=np.int64)
    for k in range(ncar):
        t = D[:, k] + car
        assert not np.any(t % (1 << L)), "carry chain broke"
        car = t >> L
        shifted[:, k] = car + p.shift
    assert np.all((shifted >= 0) & (shifted < (1 << (2 * L)))), \
        "carry out of range"
    assert not np.any(car), "final carry nonzero: identity does not hold"
    for reg in "ABCQR":
        W[off[reg]:off[reg] + NL, :nr] = limbs[reg].T
    W[off["CLO"]:off["CLO"] + ncar, :nr] = (shifted & ((1 << L) - 1)).T
    W[off["CHI"]:off["CHI"] + ncar, :nr] = (shifted >> L).T

    if layout.bind_c:
        assert binding is not None, "bind_c layout requires challenges"
        ch, gm = int(binding[0]) % P, int(binding[1]) % P
        pw = ch
        for j in range(NL):
            W[off["FPCH"] + j, :] = pw
            pw = pw * ch % P
        W[off["FGAMMA"], :] = gm
        facc = 1
        for r, row in enumerate(rows):
            W[off["FACC"], r] = facc
            if row.get("fp"):
                t = 0
                pw2 = ch
                for limb in p.split(vals[r][2]):
                    t = (t + pw2 * limb) % P
                    pw2 = pw2 * ch % P
                facc = (facc * gm + t) % P
        W[off["FACC"], nr:] = facc
    return gl.from_u64(W, device)


def result_value(layout: FFLayout, witness: gl.GF, var: FFVar) -> int:
    p = layout.params
    off = _regions(p.num_limbs)
    base = off[var.region]
    limbs = [int(v) for v in
             gl.to_u64(witness[base:base + p.num_limbs, var.row])]
    return p.join(limbs)
