"""In-circuit PLONKish verifier: a circuit that verifies one of our proofs.

Counterpart of the JAX package's `circuits/verifier_circuit.py`, the same
synthesis step for step (so the same gates, the same outer IR and VK),
over the port's builder (circuits/builder.py). The recursion kernel
(reference role: circuit_definitions/src/circuit_definitions/
recursion_layer/leaf_layer.rs, a circuit whose statement is "I verified an
inner FRI proof against this VK"), mirroring prover/plonkish._verify_inner:

  1. transcript replay: a chained Poseidon2 duplex sponge absorbing the
     inner VK, public inputs, commitment caps, OOD evaluations, FRI caps and
     final polynomial, with the challenges read from the sponge output
     lanes, byte for byte the host Transcript schedule;
  2. the OOD identity at z: the INNER circuit's gate evaluator run
     symbolically over ext-variable pairs (`BldExtAlgebra`, which does not
     `stacks_tiles`, so every inner IR takes its per-constraint list path),
     plus copy-permutation chunk terms, the logup terms of an inner circuit
     with lookups, Z_H division and PI terms via provided-inverse cells;
  3. per query: 64-bit canonical decomposition of the squeezed position,
     Merkle checks of all tree openings against the absorbed caps, DEEP
     recomputation at the opened pair of points, and the FRI fold chain
     down to a Horner evaluation of the final polynomial.

The proof being verified is a private witness; the circuit's public inputs
are the inner VK elements followed by the inner proof's public inputs. A
port proof holds its caps, OOD values, openings and paths as host ints
already (numpy arrays and lists), so `verifier_assignments` reads them
without a device transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import RATE, T
from ..prover import plonkish as pk
from . import builder as bd
from .builder import CircuitBuilder, EVar, ExtOps

P = gl.P
INV2 = pow(2, P - 2, P)
DIGEST = 4


# ---------------------------------------------------------------------------
# Static shape of an inner proof
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InnerShape:
    log_n: int
    num_witness: int
    num_const: int
    num_chunks: int
    num_q_chunks: int
    rate: int
    cap_size: int
    num_queries: int
    final_fri_size: int
    n_tables: int = 0
    table_width: int = 0
    num_sets: int = 0

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def n_comm(self) -> int:
        return self.n * self.rate

    @property
    def log_nc(self) -> int:
        return self.n_comm.bit_length() - 1

    @property
    def has_lk(self) -> bool:
        return self.num_sets > 0

    @property
    def s2_width(self) -> int:
        return 2 + 2 * (self.num_chunks - 1) + self.n_tables

    @property
    def s3_width(self) -> int:
        return (2 + 2 * self.n_tables + 2 * self.num_sets
                if self.has_lk else 0)

    @property
    def setup_width(self) -> int:
        return self.num_const + self.num_witness + self.table_width

    @property
    def rounds(self) -> int:
        return (self.n_comm // self.final_fri_size).bit_length() - 1

    @property
    def n_final(self) -> int:
        return self.n_comm >> self.rounds

    @property
    def main_depth(self) -> int:
        return (self.n_comm // self.cap_size).bit_length() - 1

    def fri_layer_leaves(self, r: int) -> int:
        return (self.n_comm >> r) // 2

    def fri_layer_cap(self, r: int) -> int:
        return min(self.cap_size, self.fri_layer_leaves(r))

    def fri_layer_depth(self, r: int) -> int:
        return (self.fri_layer_leaves(r)
                // self.fri_layer_cap(r)).bit_length() - 1


def inner_shape(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig) -> InnerShape:
    chunks = pk._copy_chunks(ir.num_witness, ir.copy_chunk)
    max_deg = max(ir.gate_degree, ir.copy_chunk + 1)
    table_width = int(sum(np.asarray(t).shape[1] for t in ir.lookup_tables))
    return InnerShape(
        log_n=ir.log_n, num_witness=ir.num_witness, num_const=ir.num_const,
        num_chunks=len(chunks), num_q_chunks=max(1, max_deg - 1),
        rate=cfg.rate, cap_size=cfg.cap_size, num_queries=cfg.num_queries,
        final_fri_size=cfg.final_fri_size,
        n_tables=len(ir.lookup_tables), table_width=table_width,
        num_sets=len(ir.lookup_sets))


# ---------------------------------------------------------------------------
# In-circuit transcript (duplex schedule of prover/transcript.py)
# ---------------------------------------------------------------------------

class CircuitTranscript:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state: List[int] = [b.zero] * T
        self.buffer: List[int] = []
        self.squeezed: List[int] = []
        self.read_since_permute = False

    def absorb(self, vs: Sequence[int]):
        self.squeezed = []
        self.read_since_permute = False
        self.buffer.extend(vs)
        while len(self.buffer) >= RATE:
            chunk, self.buffer = self.buffer[:RATE], self.buffer[RATE:]
            self.state = self.b.poseidon2(list(chunk) + self.state[RATE:])

    def _flush(self):
        if self.buffer:
            chunk = self.buffer + [self.b.zero] * (RATE - len(self.buffer))
            self.buffer = []
            self.state = self.b.poseidon2(chunk + self.state[RATE:])

    def squeeze(self) -> int:
        if not self.squeezed:
            self._flush()
            if self.read_since_permute:
                self.state = self.b.poseidon2(list(self.state))
            self.squeezed = list(self.state[:RATE])
            self.read_since_permute = True
        return self.squeezed.pop(0)

    def challenge_ext(self) -> EVar:
        return (self.squeeze(), self.squeeze())


# ---------------------------------------------------------------------------
# Bit gadgets
# ---------------------------------------------------------------------------

def decompose64(b: CircuitBuilder, v: int) -> List[int]:
    """64 boolean vars with canonical (< p) packing enforced."""
    bits = [b.bit(lambda x, i=i: (int(x) >> i) & 1, (v,)) for i in range(64)]
    lo = bits[0]
    for i in range(1, 32):
        lo = b.lin(1, lo, 1 << i, bits[i])
    hi = bits[32]
    for i in range(33, 64):
        hi = b.lin(1, hi, 1 << (i - 32), bits[i])
    total = b.lin(1, lo, 1 << 32, hi)
    b.assert_eq(total, v)
    # canonical: NOT(hi == 2^32-1 AND lo != 0)
    h_and = bits[32]
    for i in range(33, 64):
        h_and = b.mul(h_and, bits[i])
    b.assert_zero(b.mul(h_and, lo))
    return bits


def pow_from_bits(b: CircuitBuilder, bits: Sequence[int], base: int) -> int:
    """base^(sum bits_i 2^i) as a mux-product chain."""
    acc = None
    for i, bit in enumerate(bits):
        w2i = pow(base, 1 << i, P)
        t = b.lin((w2i - 1) % P, bit, c=1)
        acc = t if acc is None else b.mul(acc, t)
    return acc if acc is not None else b.constant(1)


# ---------------------------------------------------------------------------
# Hash / Merkle gadgets
# ---------------------------------------------------------------------------

def hash_row(b: CircuitBuilder, row: Sequence[int]) -> List[int]:
    """hash_elements: zero state, overwrite-absorb rate-8 chunks."""
    row = list(row)
    pad = (-len(row)) % RATE
    row = row + [b.zero] * pad
    state: Optional[List[int]] = None
    for i in range(0, len(row), RATE):
        cap = state[RATE:] if state is not None else [b.zero] * (T - RATE)
        state = b.poseidon2(row[i:i + RATE] + cap)
    return state[:DIGEST]


def merkle_check(b: CircuitBuilder, digest: Sequence[int],
                 path: Sequence[Sequence[int]], idx_bits: Sequence[int],
                 cap_vars: Sequence[int], depth: int, cap_size: int):
    """Walk a path (mux'd by index bits) and equate against the cap entry
    selected by the top bits — ops/merkle.verify_paths in gates."""
    cur = list(digest)
    for d in range(depth):
        sib = list(path[d])
        bit = idx_bits[d]
        left = [b.mux(bit, sib[i], cur[i]) for i in range(DIGEST)]
        right = [b.mux(bit, cur[i], sib[i]) for i in range(DIGEST)]
        cur = b.poseidon2(left + right + [b.zero] * (T - 2 * DIGEST))[:DIGEST]
    log_cap = cap_size.bit_length() - 1
    entries = [[cap_vars[DIGEST * e + i] for i in range(DIGEST)]
               for e in range(cap_size)]
    for l in range(log_cap):
        bit = idx_bits[depth + l]
        entries = [[b.mux(bit, entries[2 * j + 1][i], entries[2 * j][i])
                    for i in range(DIGEST)]
                   for j in range(len(entries) // 2)]
    for i in range(DIGEST):
        b.assert_eq(cur[i], entries[0][i])


# ---------------------------------------------------------------------------
# Builder algebra for the inner gate evaluator
# ---------------------------------------------------------------------------

class BldExtAlgebra:
    """HostExtAlgebra over builder EVar pairs: lets the INNER circuit's own
    eval_gates run symbolically inside the verifier circuit."""

    def __init__(self, ext: ExtOps):
        self.e = ext

    def add(self, a: EVar, b: EVar) -> EVar:
        return self.e.add(a, b)

    def sub(self, a: EVar, b: EVar) -> EVar:
        return self.e.sub(a, b)

    def mul(self, a: EVar, b: EVar) -> EVar:
        return self.e.mul(a, b)

    def mul_int(self, a: EVar, c: int) -> EVar:
        return self.e.scale_int(a, c)

    def add_int(self, a: EVar, c: int) -> EVar:
        return (self.e.b.add_int(a[0], c), a[1])


def _combine_pair(ext: ExtOps, p0: EVar, p1: EVar) -> EVar:
    """v0 + (0,1)*v1 for two ext evaluations (host: eadd(p0, emul((0,1),p1)))."""
    b = ext.b
    return (b.lin(1, p0[0], bd.W_EXT, p1[1]), b.add(p0[1], p1[0]))


# ---------------------------------------------------------------------------
# Layout of the proof-as-witness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VerifierLayout:
    shape: InnerShape
    inner_ir: pk.PlonkishIR
    builder: CircuitBuilder
    vk_vars: List[int] = dataclasses.field(default_factory=list)
    inner_pi_vars: List[int] = dataclasses.field(default_factory=list)
    caps: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    ood: Dict[str, List[EVar]] = dataclasses.field(default_factory=dict)
    fri_caps: List[List[int]] = dataclasses.field(default_factory=list)
    final_poly: List[EVar] = dataclasses.field(default_factory=list)
    # per tree: [2*q + half] -> row vars / path [depth][4]
    openings: Dict[str, List[List[int]]] = dataclasses.field(default_factory=dict)
    paths: Dict[str, List[List[List[int]]]] = dataclasses.field(default_factory=dict)
    fri_leaves: List[List[List[int]]] = dataclasses.field(default_factory=list)
    fri_paths: List[List[List[List[int]]]] = dataclasses.field(default_factory=list)



def _tree_widths(sh: InnerShape) -> Dict[str, int]:
    out = {"witness": sh.num_witness, "stage2": sh.s2_width}
    if sh.has_lk:
        out["stage3"] = sh.s3_width
    out["quotient"] = 2 * sh.num_q_chunks
    out["setup"] = sh.setup_width
    return out


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def synthesize_verifier(inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
                        slots: int = 8) -> Tuple[CircuitBuilder, VerifierLayout]:
    """One proof check in its own circuit; vk + inner PIs exposed as the
    circuit's public inputs (the compression-mode shape)."""
    b = CircuitBuilder(slots=slots)
    lay = synthesize_proof_check(b, inner_ir, inner_cfg)
    for v in lay.vk_vars + lay.inner_pi_vars:
        b.mark_public(v)
    return b, lay


def synthesize_proof_check(b: CircuitBuilder, inner_ir: pk.PlonkishIR,
                           inner_cfg: pk.PlonkishConfig,
                           vk_vars: Optional[List[int]] = None
                           ) -> VerifierLayout:
    """Emit the gates of ONE full proof verification into an existing builder
    (aggregation circuits instantiate this once per child). `vk_vars` shares
    an already-allocated VK across instances; public-input marking is the
    caller's choice."""
    sh = inner_shape(inner_ir, inner_cfg)
    ext = ExtOps(b)
    lay = VerifierLayout(shape=sh, inner_ir=inner_ir, builder=b)
    tr = CircuitTranscript(b)

    # -- proof data as input variables (fixed layout) ----------------------
    lay.vk_vars = (vk_vars if vk_vars is not None
                   else b.inputs(sh.cap_size * DIGEST))
    lay.inner_pi_vars = b.inputs(len(inner_ir.public_input_cells))
    cap_names = (("witness", "stage2", "stage3", "quotient") if sh.has_lk
                 else ("witness", "stage2", "quotient"))
    for name in cap_names:
        lay.caps[name] = b.inputs(sh.cap_size * DIGEST)

    def ood_pairs(k: int) -> List[EVar]:
        return [tuple(b.inputs(2)) for _ in range(k)]

    lay.ood["witness"] = ood_pairs(sh.num_witness)
    lay.ood["witness_next"] = ood_pairs(sh.num_witness)
    lay.ood["stage2"] = ood_pairs(sh.s2_width)
    lay.ood["stage2_next"] = ood_pairs(sh.s2_width)
    lay.ood["stage3"] = ood_pairs(sh.s3_width)
    lay.ood["stage3_next"] = ood_pairs(sh.s3_width)
    lay.ood["table"] = ood_pairs(sh.table_width)
    lay.ood["const"] = ood_pairs(sh.num_const)
    lay.ood["sigma"] = ood_pairs(sh.num_witness)
    lay.ood["quotient"] = ood_pairs(2 * sh.num_q_chunks)
    lay.fri_caps = [b.inputs(sh.fri_layer_cap(r) * DIGEST)
                    for r in range(1, sh.rounds)]
    lay.final_poly = [tuple(b.inputs(2)) for _ in range(sh.n_final)]
    widths = _tree_widths(sh)
    for name, w in widths.items():
        lay.openings[name] = [b.inputs(w) for _ in range(2 * sh.num_queries)]
        lay.paths[name] = [[b.inputs(DIGEST) for _ in range(sh.main_depth)]
                           for _ in range(2 * sh.num_queries)]
    for r in range(1, sh.rounds):
        lay.fri_leaves.append([b.inputs(4) for _ in range(sh.num_queries)])
        lay.fri_paths.append(
            [[b.inputs(DIGEST) for _ in range(sh.fri_layer_depth(r))]
             for _ in range(sh.num_queries)])

    # -- 1. transcript replay ---------------------------------------------
    tr.absorb(lay.vk_vars)
    tr.absorb(lay.inner_pi_vars)
    tr.absorb(lay.caps["witness"])
    beta = tr.challenge_ext()
    gamma = tr.challenge_ext()
    tr.absorb(lay.caps["stage2"])
    theta = beta_lk = None
    if sh.has_lk:
        theta = tr.challenge_ext()
        beta_lk = tr.challenge_ext()
        tr.absorb(lay.caps["stage3"])
    alpha = tr.challenge_ext()
    tr.absorb(lay.caps["quotient"])
    z = tr.challenge_ext()
    for pair in (lay.ood["witness"] + lay.ood["witness_next"]
                 + lay.ood["stage2"] + lay.ood["stage2_next"]
                 + lay.ood["stage3"] + lay.ood["stage3_next"]
                 + lay.ood["table"] + lay.ood["const"] + lay.ood["sigma"]
                 + lay.ood["quotient"]):
        tr.absorb([pair[0], pair[1]])
    gamma_deep = tr.challenge_ext()

    # -- 2. OOD identity ---------------------------------------------------
    alg = BldExtAlgebra(ext)
    gate_vals = inner_ir.eval_gates(alg, lay.ood["witness"],
                                    lay.ood["witness_next"],
                                    lay.ood["const"])
    assert len(gate_vals) == inner_ir.num_gate_constraints

    z_ext = _combine_pair(ext, lay.ood["stage2"][0], lay.ood["stage2"][1])
    z_next = _combine_pair(ext, lay.ood["stage2_next"][0],
                           lay.ood["stage2_next"][1])
    pp_ext = [_combine_pair(ext, lay.ood["stage2"][2 + 2 * t],
                            lay.ood["stage2"][3 + 2 * t])
              for t in range(sh.num_chunks - 1)]

    chunks = pk._copy_chunks(sh.num_witness, inner_ir.copy_chunk)
    ks = gl.powers_host(pk.K_COSET_GEN, max(sh.num_witness, 1)).astype(object)
    bz = ext.mul(beta, z)
    copy_vals: List[EVar] = []
    prev = z_ext
    for t, chunk in enumerate(chunks):
        num_p = ext.const((1, 0))
        den_p = ext.const((1, 0))
        for j in chunk:
            w_j = lay.ood["witness"][j]
            id_term = ext.add(ext.add(w_j, ext.scale_int(bz, int(ks[j]))),
                              gamma)
            sg_term = ext.add(ext.add(w_j, ext.mul(beta, lay.ood["sigma"][j])),
                              gamma)
            num_p = ext.mul(num_p, id_term)
            den_p = ext.mul(den_p, sg_term)
        nxt = pp_ext[t] if t < len(chunks) - 1 else z_next
        copy_vals.append(ext.sub(ext.mul(nxt, den_p), ext.mul(prev, num_p)))
        prev = pp_ext[t] if t < len(chunks) - 1 else None

    # lookup (logup) constraint values at z
    lookup_vals: List[EVar] = []
    s_ext_lk = None
    if sh.has_lk:
        def pair_at(pairs, i):
            return _combine_pair(ext, pairs[2 * i], pairs[2 * i + 1])

        s_ext_lk = pair_at(lay.ood["stage3"], 0)
        s_next_lk = _combine_pair(ext, lay.ood["stage3_next"][0],
                                  lay.ood["stage3_next"][1])
        h_tables = [pair_at(lay.ood["stage3"], 1 + t)
                    for t in range(sh.n_tables)]
        h_sets = [pair_at(lay.ood["stage3"], 1 + sh.n_tables + s)
                  for s in range(sh.num_sets)]
        m_ofs = 2 + 2 * (sh.num_chunks - 1)
        tslices = pk._table_col_slices(inner_ir)

        def compress_ood(vals, theta_c):
            acc = vals[0]
            tp = ext.const((1, 0))
            for v2 in vals[1:]:
                tp = ext.mul(tp, theta_c)
                acc = ext.add(acc, ext.mul(tp, v2))
            return acc

        for s, (_tbl, cols) in enumerate(inner_ir.lookup_sets):
            a_comp = compress_ood([lay.ood["witness"][c] for c in cols],
                                  theta)
            denom = ext.add(a_comp, beta_lk)
            prod_hd = ext.mul(h_sets[s], denom)
            lookup_vals.append((b.add_int(prod_hd[0], P - 1), prod_hd[1]))
        for t, (start, width) in enumerate(tslices):
            t_comp = compress_ood([lay.ood["table"][start + j]
                                   for j in range(width)], theta)
            denom = ext.add(t_comp, beta_lk)
            m_val = lay.ood["stage2"][m_ofs + t]
            lookup_vals.append(ext.sub(ext.mul(h_tables[t], denom), m_val))
        s_trans = ext.sub(s_next_lk, s_ext_lk)
        for h in h_sets:
            s_trans = ext.sub(s_trans, h)
        for h in h_tables:
            s_trans = ext.add(s_trans, h)
        lookup_vals.append(s_trans)

    comb = ext.const((0, 0))
    apow = ext.const((1, 0))
    for gv in gate_vals + copy_vals + lookup_vals:
        apow = ext.mul(apow, alpha)
        comb = ext.add(comb, ext.mul(apow, gv))
    # zn = z^n via square chain; zh = zn - 1
    zn = z
    for _ in range(sh.log_n):
        zn = ext.mul(zn, zn)
    zh = (b.add_int(zn[0], P - 1), zn[1])
    comb = ext.mul(comb, ext.inverse(zh))
    apow_b = ext.mul(apow, alpha)
    zm1 = (b.add_int(z_ext[0], P - 1), z_ext[1])
    z_minus_1 = (b.add_int(z[0], P - 1), z[1])
    inv_zm1 = ext.inverse(z_minus_1)
    comb = ext.add(comb, ext.mul(apow_b, ext.mul(zm1, inv_zm1)))
    if sh.has_lk:
        apow_b = ext.mul(apow_b, alpha)
        comb = ext.add(comb, ext.mul(apow_b, ext.mul(s_ext_lk, inv_zm1)))
    w_gen = gl.primitive_root_of_unity(sh.log_n)
    apow_pi = apow_b
    for (col, row), pi_var in zip(inner_ir.public_input_cells,
                                  lay.inner_pi_vars):
        apow_pi = ext.mul(apow_pi, alpha)
        pt = pow(w_gen, row, P)
        w_col = lay.ood["witness"][col]
        num = (b.sub(w_col[0], pi_var), w_col[1])
        den = (b.add_int(z[0], P - int(pt)), z[1])
        comb = ext.add(comb, ext.mul(apow_pi,
                                     ext.mul(num, ext.inverse(den))))

    expected = ext.const((0, 0))
    zjn = ext.const((1, 0))
    for j in range(sh.num_q_chunks):
        qz = _combine_pair(ext, lay.ood["quotient"][2 * j],
                           lay.ood["quotient"][2 * j + 1])
        expected = ext.add(expected, ext.mul(zjn, qz))
        zjn = ext.mul(zjn, zn)
    ext.assert_eq(comb, expected)

    # -- 3. FRI transcript tail -------------------------------------------
    alphas: List[EVar] = []
    for r in range(sh.rounds):
        alphas.append(tr.challenge_ext())
        if r < sh.rounds - 1:
            tr.absorb(lay.fri_caps[r])
    for c0, c1 in lay.final_poly:
        tr.absorb([c0, c1])
    pos_vars = [tr.squeeze() for _ in range(sh.num_queries)]

    # degree bound on the final polynomial
    deg_bound = sh.n_final // sh.rate
    for c0, c1 in lay.final_poly[deg_bound:]:
        b.assert_zero(c0)
        b.assert_zero(c1)

    # -- DEEP gamma powers (shared across queries) ------------------------
    deep_order = [("witness", "witness", False), ("witness", "witness_next", True),
                  ("stage2", "stage2", False), ("stage2", "stage2_next", True)]
    if sh.has_lk:
        deep_order += [("stage3", "stage3", False),
                       ("stage3", "stage3_next", True)]
    deep_order += [("setup", None, False), ("quotient", "quotient", False)]
    ood_setup = lay.ood["const"] + lay.ood["sigma"] + lay.ood["table"]
    total_terms = (2 * sh.num_witness + 2 * sh.s2_width + 2 * sh.s3_width
                   + sh.setup_width + 2 * sh.num_q_chunks)
    gammas: List[EVar] = []
    g = gamma_deep
    gammas.append(g)
    for _ in range(total_terms - 1):
        g = ext.mul(g, gamma_deep)
        gammas.append(g)
    # negated c1 components of each ood value, shared across queries
    neg1: Dict[str, List[int]] = {}
    for key, pairs in (("witness", lay.ood["witness"]),
                       ("witness_next", lay.ood["witness_next"]),
                       ("stage2", lay.ood["stage2"]),
                       ("stage2_next", lay.ood["stage2_next"]),
                       ("stage3", lay.ood["stage3"]),
                       ("stage3_next", lay.ood["stage3_next"]),
                       ("setup", ood_setup),
                       ("quotient", lay.ood["quotient"])):
        neg1[key] = [b.mul_int(p[1], P - 1) for p in pairs]

    shift = gl.MULTIPLICATIVE_GENERATOR
    v_root = gl.primitive_root_of_unity(sh.log_nc)
    zw = ext.scale_int(z, w_gen)

    shifts = [shift]
    for _ in range(sh.rounds):
        shifts.append((shifts[-1] * shifts[-1]) % P)
    w_r = [gl.primitive_root_of_unity(sh.log_nc - r)
           for r in range(sh.rounds + 1)]

    def deep_at(x_var: int, pos_slot: int) -> EVar:
        """DEEP composition at LDE point x from this slot's opened rows."""
        diff_z = (b.sub(x_var, z[0]), b.mul_int(z[1], P - 1))
        diff_zw = (b.sub(x_var, zw[0]), b.mul_int(zw[1], P - 1))
        inv_xz = ext.inverse(diff_z)
        inv_xzw = ext.inverse(diff_zw)
        gi = 0
        acc_z: Optional[EVar] = None
        acc_w: Optional[EVar] = None
        for tree, ood_key, is_next in deep_order:
            rows = lay.openings[tree][pos_slot]
            oods = ood_setup if ood_key is None else lay.ood[ood_key]
            negs = neg1[ood_key if ood_key is not None else "setup"]
            assert len(rows) == len(oods)
            for j in range(len(oods)):
                num = (b.sub(rows[j], oods[j][0]), negs[j])
                term = ext.mul(gammas[gi], num)
                gi += 1
                if is_next:
                    acc_w = term if acc_w is None else ext.add(acc_w, term)
                else:
                    acc_z = term if acc_z is None else ext.add(acc_z, term)
        assert gi == total_terms
        return ext.add(ext.mul(acc_z, inv_xz), ext.mul(acc_w, inv_xzw))

    # -- per-query checks --------------------------------------------------
    h0 = sh.n_comm // 2
    log_h0 = sh.log_nc - 1
    zero_bit = b.constant(0)
    one_bit = b.constant(1)
    for q in range(sh.num_queries):
        bits = decompose64(b, pos_vars[q])
        j_bits = bits[:log_h0]
        x_lo = b.mul_int(pow_from_bits(b, j_bits, v_root), shift)
        x_hi = b.mul_int(x_lo, P - 1)

        values: List[EVar] = []
        for half, (x_var, top) in enumerate(((x_lo, zero_bit),
                                             (x_hi, one_bit))):
            slot = 2 * q + half
            idx_bits = j_bits + [top]
            for name, w in _tree_widths(sh).items():
                digest = hash_row(b, lay.openings[name][slot])
                cap = (lay.vk_vars if name == "setup" else lay.caps[name])
                merkle_check(b, digest, lay.paths[name][slot], idx_bits,
                             cap, sh.main_depth, sh.cap_size)
            values.append(deep_at(x_var, slot))

        a, bb = values[0], values[1]
        m = log_h0  # current j bit-width
        value: Optional[EVar] = None
        for r in range(sh.rounds):
            n_r = sh.n_comm >> r
            h_r = n_r // 2
            if r > 0:
                leaf = lay.fri_leaves[r - 1][q]
                a_leaf: EVar = (leaf[0], leaf[1])
                b_leaf: EVar = (leaf[2], leaf[3])
                # Merkle check of this layer's pair leaf
                lidx_bits = j_bits[:(h_r).bit_length() - 1]
                digest = hash_row(b, list(leaf))
                merkle_check(b, digest, lay.fri_paths[r - 1][q], lidx_bits,
                             lay.fri_caps[r - 1], sh.fri_layer_depth(r),
                             sh.fri_layer_cap(r))
                sel = j_bits[h_r.bit_length() - 1]  # j >= h_r bit
                expected_v = ext.mux(sel, b_leaf, a_leaf)
                ext.assert_eq(value, expected_v)
                a, bb = a_leaf, b_leaf
                m = h_r.bit_length() - 1
            # fold at index j = j_bits[:m] of layer r
            d = b.mul_int(pow_from_bits(b, j_bits[:m], w_r[r]), shifts[r])
            inv_d = b.inverse(d)
            e_val = ext.scale_int(ext.add(a, bb), INV2)
            o_val = ext.scale_int(ext.mul_base(ext.sub(a, bb), inv_d), INV2)
            value = ext.add(e_val, ext.mul(alphas[r], o_val))
        # final polynomial evaluation at x = shifts[R] * w_R^(j mod n_f)
        nf_bits = j_bits[:sh.n_final.bit_length() - 1]
        x_f = b.mul_int(pow_from_bits(b, nf_bits, w_r[sh.rounds]),
                        shifts[sh.rounds])
        acc = lay.final_poly[-1]
        for k in range(sh.n_final - 2, -1, -1):
            acc = ext.add(ext.mul_base(acc, x_f), lay.final_poly[k])
        ext.assert_eq(acc, value)

    return lay


# ---------------------------------------------------------------------------
# Witness filling from a concrete proof
# ---------------------------------------------------------------------------

def verifier_assignments(lay: VerifierLayout, vk: Sequence[int],
                         proof: pk.PlonkishProof) -> Dict[int, int]:
    sh = lay.shape
    asg: Dict[int, int] = {}

    def put(vars_, vals):
        vals = list(vals)
        assert len(vars_) == len(vals), (len(vars_), len(vals))
        for var, val in zip(vars_, vals):
            asg[var] = int(val) % P

    put(lay.vk_vars, vk)
    put(lay.inner_pi_vars, proof.public_inputs)
    put(lay.caps["witness"],
        np.asarray(proof.witness_cap, dtype=object).ravel())
    put(lay.caps["stage2"], np.asarray(proof.stage2_cap, dtype=object).ravel())
    if sh.has_lk:
        put(lay.caps["stage3"],
            np.asarray(proof.stage3_cap, dtype=object).ravel())
    put(lay.caps["quotient"],
        np.asarray(proof.quotient_cap, dtype=object).ravel())
    for key, pairs in (("witness", proof.ood_witness),
                       ("witness_next", proof.ood_witness_next),
                       ("stage2", proof.ood_stage2),
                       ("stage2_next", proof.ood_stage2_next),
                       ("stage3", proof.ood_stage3),
                       ("stage3_next", proof.ood_stage3_next),
                       ("table", proof.ood_table),
                       ("const", proof.ood_const),
                       ("sigma", proof.ood_sigma),
                       ("quotient", proof.ood_quotient)):
        for (v0, v1), pair in zip(lay.ood[key], pairs):
            asg[v0] = int(pair[0]) % P
            asg[v1] = int(pair[1]) % P
    for r, cap_vars in enumerate(lay.fri_caps):
        put(cap_vars, np.asarray(proof.fri.caps[r], dtype=object).ravel())
    for (v0, v1), (c0, c1) in zip(lay.final_poly, proof.fri.final_poly):
        asg[v0] = int(c0) % P
        asg[v1] = int(c1) % P

    h0 = sh.n_comm // 2
    positions = [int(p) for p in proof.fri.query_positions]
    assert len(positions) == sh.num_queries
    for q, p0 in enumerate(positions):
        j0 = p0 % h0
        for half, pos in enumerate((j0, j0 + h0)):
            slot = 2 * q + half
            for name in _tree_widths(sh):
                put(lay.openings[name][slot], proof.openings[name][pos])
                path = np.asarray(proof.paths[name][pos], dtype=object)
                for d in range(sh.main_depth):
                    put(lay.paths[name][slot][d], path[d])
    for r in range(1, sh.rounds):
        op = proof.fri.openings[r - 1]
        for q in range(sh.num_queries):
            put(lay.fri_leaves[r - 1][q], op.leaves[q])
            for d in range(sh.fri_layer_depth(r)):
                put(lay.fri_paths[r - 1][q][d], op.paths[q][d])
    return asg


def verifier_public_inputs(vk: Sequence[int],
                           proof: pk.PlonkishProof) -> List[int]:
    return [int(v) % P for v in vk] + [int(v) % P for v in proof.public_inputs]
