"""In-SNARK verification of a compression-for-wrapper FRI proof.

Parity target: the reference `WrapperCircuit` verifies the
compression-for-wrapper proof INSIDE the BN254 PLONK circuit
(src/proof_wrapper_utils/wrapper.rs:108-275 — the circuit
is `WrapperCircuit { fn synthesize }` running boojum's
`verify_proof_in_snark` over a CircuitPoseidon2Sponge transcript at a 2^24
domain). This module builds that statement over our PLONK
(utils/plonk.py + utils/plonk_builder.py):

  * full Fiat-Shamir transcript replay of prover/hash_backend.Bn254Transcript
    (width-3 Poseidon2-BN254 sponge, overwrite mode) — the for-wrapper
    VK cap, public inputs, stage caps, OOD values, FRI caps, final
    polynomial and query indices are all re-derived in-circuit;
  * the OOD quotient identity of prover/plonkish._verify_inner — gate
    constraints evaluated through `ir.eval_gates` with a PLONK-gate-emitting
    Goldilocks-extension Algebra (the same write-once Algebra adapter the
    device/host evaluators use), plus copy-permutation chunks, logup lookup
    terms, boundary terms and public-input terms;
  * Merkle membership of every queried row against the absorbed caps
    (Poseidon2-BN254 leaf hash + path walk with in-circuit index bits);
  * the DEEP recomputation at each queried point and the FRI
    fold-consistency walk down to the final polynomial (degree-checked,
    evaluated in-circuit).

Goldilocks arithmetic is emulated in BN254 Fr with LAZY reduction: every
emulated value carries an exact magnitude bound; products/sums accumulate
unreduced while they fit Fr (253 bits), and a witness-hinted `x = q*P + r`
reduction (with bit-decomposed range checks) is emitted only when a bound
would overflow. This keeps e.g. one DEEP term at ~10 gates instead of the
~500 a reduce-every-op scheme costs.

Soundness notes:
  * absorbed Goldilocks proof values are range-checked CANONICAL (< P), so
    the in-circuit transcript absorbs exactly the bytes the host prover
    absorbed;
  * Fr sponge squeezes are decomposed as lo64 + 2^64*mid64 + 2^128*hi with
    hi <= (R >> 128) enforced, pinning the decomposition (up to the
    negligible fr < 2^128 - R_lo ambiguity window of the canonical trick);
  * every inverse is a witness hint checked by multiplication, and every
    equality is a proven x = q*P (multiple-of-P) constraint.

Counterpart of the JAX package's `utils/snark_fri_verifier.py`, moved
across as it is: the statement is host Python over the port's
`plonk_builder` and its circuit IRs (`ir.eval_gates` on the gadget
algebra), so a statement built over the same proof has the same selectors,
wiring and assignment in both packages (`convert.plonk_statement_digests`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from . import field_int as fi
from . import plonk as pl
from . import plonk_builder as pb
from .bn254 import R
from .poseidon2_bn254 import RATE, T

P = fi.P
W_EXT = fi.W_EXT
MAXB = 1 << 250  # max tracked magnitude (R is ~2^253.6; margin for sums)
R_HI = R >> 128  # 126-bit top limb bound for squeeze decompositions


# ---------------------------------------------------------------------------
# Lazy-bound emulated Goldilocks values over PLONK gates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class V:
    """One emulated Goldilocks value: a PLONK var (or a constant) whose Fr
    residue equals the exact integer value, `bound` an exclusive magnitude
    bound (so Fr arithmetic below `MAXB` is exact integer arithmetic)."""
    var: Optional[int]  # PLONK builder var id; None => constant
    cv: int             # constant value when var is None
    bound: int

    @property
    def is_const(self) -> bool:
        return self.var is None


EGL = Tuple[V, V]  # Goldilocks quadratic extension (x^2 = 7)


class G:
    """Gadget context: emulated-Goldilocks ops over a PlonkBuilder."""

    def __init__(self, b: pb.PlonkBuilder):
        self.b = b
        self.n_reductions = 0
        self._marks: List[Tuple[str, int]] = []
        self._red_cache: Dict[int, V] = {}

    def mark(self, name: str):
        self._marks.append((name, len(self.b.qL)))

    def section_gates(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (name, start), (_n2, end) in zip(self._marks,
                                             self._marks[1:]
                                             + [("end", len(self.b.qL))]):
            out[name] = out.get(name, 0) + (end - start)
        return out

    # -- constants / inputs -------------------------------------------------

    def const(self, c: int) -> V:
        c = int(c) % P
        return V(None, c, c + 1)

    def econst(self, pair) -> EGL:
        return (self.const(pair[0]), self.const(pair[1]))

    def raw_input(self) -> int:
        """An un-range-checked Fr input var (cap digests, path digests)."""
        return self.b.input()

    def const_var(self, c: int) -> int:
        """Materialize a constant as a PLONK var (for sponge lanes)."""
        c = int(c) % R
        v = self.b._out(lambda: c, ())
        self.b._gate(a=v, qL=1, qC=(-c) % R)
        return v

    def input_gl(self) -> V:
        """Canonical Goldilocks input: range-checked v < P (64-bit split into
        hi32/lo32 plus the is-max corner constraint — P = (2^32-1)*2^32+1)."""
        x = self.b.input()
        lo32 = self._decompose(x, 32, full_recompose=False)
        hi32_var = self.b._out(lambda vx: (vx >> 32) % (1 << 32), (x,))
        hi_bits = self._decompose(hi32_var, 32, full_recompose=True)
        # x = hi32 * 2^32 + lo32
        self.b._gate(a=hi32_var, b=lo32, c=x, qL=(1 << 32), qR=1, qO=R - 1)
        # v < P  <=>  not(hi32 == 2^32-1 and lo32 != 0)
        mx = (1 << 32) - 1
        d = self.b.lin(1, hi32_var, c0=(-mx) % R)       # d = hi32 - (2^32-1)
        dinv = self.b._out(lambda vd: pow(vd, R - 2, R) if vd else 0, (d,))
        is_max = self.b._out(lambda vd: 1 if vd == 0 else 0, (d,))
        # is_max = 1 - d*dinv ; is_max * d = 0 ; is_max * lo32 = 0
        self.b._gate(a=d, b=dinv, c=is_max, qM=1, qO=1, qC=R - 1)
        self.b._gate(a=is_max, b=d, qM=1)
        self.b._gate(a=is_max, b=lo32, qM=1)
        del hi_bits
        return V(x, 0, P)

    def input_egl(self) -> EGL:
        return (self.input_gl(), self.input_gl())

    # -- bit decomposition ---------------------------------------------------

    def _decompose(self, x: int, nbits: int, full_recompose: bool = True,
                   shift: int = 0):
        """Constrain the var `x`'s bits [shift, shift+nbits) and return the
        var of sum(b_k 2^k) (the low part when shift=0). With
        full_recompose the sum is asserted equal to x."""
        b = self.b
        acc = None
        for k in range(nbits):
            kk = shift + k
            bit = b._out(lambda vx, _k=kk: (vx >> _k) & 1, (x,))
            b._gate(a=bit, b=bit, qM=1, qL=R - 1)  # bit^2 - bit = 0
            if acc is None:
                acc = b.lin(1 << k, bit)
            else:
                acc = b.lin(1, acc, 1 << k, bit)
        if full_recompose:
            b.assert_eq(acc, x)
        return acc

    def bits_of(self, x: int, nbits: int) -> List[int]:
        """Bit vars of x (low `nbits` bits; asserts x < 2^nbits)."""
        b = self.b
        bits = []
        acc = None
        for k in range(nbits):
            bit = b._out(lambda vx, _k=k: (vx >> _k) & 1, (x,))
            b._gate(a=bit, b=bit, qM=1, qL=R - 1)
            bits.append(bit)
            acc = b.lin(1 << k, bit) if acc is None else \
                b.lin(1, acc, 1 << k, bit)
        b.assert_eq(acc, x)
        return bits

    # -- core arithmetic with bound tracking ----------------------------------

    def add(self, x: V, y: V) -> V:
        if x.is_const and y.is_const:
            return V(None, x.cv + y.cv, x.bound + y.bound)
        if x.is_const:
            x, y = y, x
        if y.is_const:
            if y.cv == 0:
                return x
            z = self.b.lin(1, x.var, c0=y.cv)
        else:
            z = self.b.add(x.var, y.var)
        return V(z, 0, x.bound + y.bound)

    def lincomb(self, cx: int, x: V, cy: int, y: V) -> V:
        """cx*x + cy*y with NON-NEGATIVE integer coefficients."""
        assert cx >= 0 and cy >= 0
        if x.is_const and y.is_const:
            return V(None, cx * x.cv + cy * y.cv,
                     cx * x.bound + cy * y.bound + 1)
        if x.is_const:
            return self.lincomb(cy, y, cx, x)
        if y.is_const:
            z = self.b.lin(cx, x.var, c0=cy * y.cv)
        else:
            z = self.b.lin(cx, x.var, cy, y.var)
        return V(z, 0, cx * x.bound + cy * y.bound)

    def neg(self, x: V) -> V:
        """kP - x (non-negative integer congruent to -x mod P)."""
        k = (x.bound + P - 1) // P
        if x.is_const:
            return V(None, k * P - x.cv, k * P + 1)
        z = self.b.lin(R - 1, x.var, c0=k * P)
        return V(z, 0, k * P + 1)

    def sub(self, x: V, y: V) -> V:
        return self.add(x, self.neg(y))

    def mul(self, x: V, y: V) -> V:
        if x.is_const and y.is_const:
            return V(None, x.cv * y.cv, x.bound * y.bound)
        if x.bound * y.bound > MAXB:
            # reduce the larger side (repeat if a single reduce can't fit)
            if x.bound >= y.bound:
                x = self.reduce(x)
            else:
                y = self.reduce(y)
            if x.bound * y.bound > MAXB:
                x, y = self.reduce(x), self.reduce(y)
        if x.is_const:
            x, y = y, x
        if y.is_const:
            if y.cv == 0:
                return self.const(0)
            if y.cv == 1:
                return x
            z = self.b.lin(y.cv, x.var)
        else:
            z = self.b.mul(x.var, y.var)
        return V(z, 0, x.bound * y.bound)

    def reduce(self, x: V) -> V:
        """x -> r with r = x mod P, r < 2^64 (loose: not canonical)."""
        if x.is_const:
            return self.const(x.cv)
        if x.bound <= (1 << 64):
            return x
        cached = self._red_cache.get(x.var)
        if cached is not None:
            return cached
        self.n_reductions += 1
        b = self.b
        q = b._out(lambda vx: vx // P, (x.var,))
        r = b._out(lambda vx: vx % P, (x.var,))
        # x - q*P - r = 0
        b._gate(a=q, b=r, c=x.var, qL=(-P) % R, qR=R - 1, qO=1)
        q_bits = (x.bound // P).bit_length()
        self.bits_of(q, q_bits)
        self.bits_of(r, 64)
        out = V(r, 0, 1 << 64)
        self._red_cache[x.var] = out
        return out

    def assert_zero(self, x: V):
        """Prove x ≡ 0 (mod P): x = q*P with q range-checked."""
        if x.is_const:
            assert x.cv % P == 0, "constant assert_zero failed at build time"
            return
        b = self.b
        q = b._out(lambda vx: vx // P, (x.var,))
        b._gate(a=q, b=x.var, qL=(-P) % R, qR=1)  # x - q*P = 0
        self.bits_of(q, (x.bound // P).bit_length() + 1)

    def assert_eq(self, x: V, y: V):
        self.assert_zero(self.sub(x, y))

    # -- extension-field ops ---------------------------------------------------

    def eadd(self, a: EGL, b: EGL) -> EGL:
        return (self.add(a[0], b[0]), self.add(a[1], b[1]))

    def esub(self, a: EGL, b: EGL) -> EGL:
        return (self.sub(a[0], b[0]), self.sub(a[1], b[1]))

    def emul(self, a: EGL, b: EGL) -> EGL:
        c0 = self.add(self.mul(a[0], b[0]),
                      self.mul(self.mul(a[1], b[1]), self.const(W_EXT)))
        c1 = self.add(self.mul(a[0], b[1]), self.mul(a[1], b[0]))
        return (c0, c1)

    def escale(self, a: EGL, c: int) -> EGL:
        cc = self.const(c)
        return (self.mul(a[0], cc), self.mul(a[1], cc))

    def ereduce(self, a: EGL) -> EGL:
        return (self.reduce(a[0]), self.reduce(a[1]))

    def eassert_zero(self, a: EGL):
        self.assert_zero(a[0])
        self.assert_zero(a[1])

    def eassert_eq(self, a: EGL, b: EGL):
        self.eassert_zero(self.esub(a, b))

    def mul_i(self, a: EGL) -> EGL:
        """(0,1) * (a0,a1) = (7*a1, a0)."""
        return (self.mul(a[1], self.const(W_EXT)), a[0])

    def _as_var(self, x: V) -> int:
        return x.var if not x.is_const else self.const_var(x.cv % R)

    def einv_hint(self, a: EGL) -> EGL:
        """Witness-hinted extension inverse, checked by a*inv == 1 (mod P).
        No input reductions: the hint lambda reduces mod P itself, and the
        product check tolerates any tracked bound (one q*P constraint)."""
        b = self.b

        def _hint(i):
            def f(v0, v1):
                inv = fi.einv((v0 % P, v1 % P))
                return inv[i]
            return f

        va0, va1 = self._as_var(a[0]), self._as_var(a[1])
        i0 = b._out(_hint(0), (va0, va1))
        i1 = b._out(_hint(1), (va0, va1))
        self.bits_of(i0, 64)
        self.bits_of(i1, 64)
        inv = (V(i0, 0, 1 << 64), V(i1, 0, 1 << 64))
        prod = self.emul(a, inv)
        self.eassert_eq(prod, self.econst((1, 0)))
        return inv

    def inv_hint(self, a: V) -> V:
        """Base-field hinted inverse, checked by a*inv == 1 (mod P)."""
        va = self._as_var(a)
        i = self.b._out(lambda v: pow(v % P, P - 2, P), (va,))
        self.bits_of(i, 64)
        inv = V(i, 0, 1 << 64)
        self.assert_zero(self.sub(self.mul(a, inv), self.const(1)))
        return inv

    def epow_const_exp(self, a: EGL, e: int) -> EGL:
        result: EGL = self.econst((1, 0))
        base = a
        while e > 0:
            if e & 1:
                result = self.emul(result, base)
                result = self.ereduce(result)
            base = self.ereduce(self.emul(base, base))
            e >>= 1
        return result

    def pow_const_base_bits(self, base: int, bits: Sequence[int]) -> V:
        """base^j for j given by bit vars (base a known field constant):
        prod_k (1 + b_k*(base^{2^k} - 1)) — one lin + one mul per bit."""
        acc: V = self.const(1)
        cur = base % P
        for bit in bits:
            # t = 1 + b*(cur-1)
            t = V(self.b.lin((cur - 1) % R, bit, c0=1), 0, P)
            acc = self.mul(acc, t)
            acc = self.reduce(acc)
            cur = (cur * cur) % P
        return acc

    def mux(self, bit: int, x: int, y: int) -> int:
        """Raw-var mux: bit ? x : y (bit a boolean var)."""
        d = self.b._gate  # noqa — keep simple: z = y + bit*(x-y)
        diff = self.b.lin(1, x, R - 1, y)
        t = self.b.mul(bit, diff)
        return self.b.add(y, t)

    def mux_tree(self, vals: List[int], bits: List[int]) -> int:
        """Select vals[idx] for idx given by bit vars (LSB first)."""
        cur = list(vals)
        for bit in bits:
            nxt = []
            for i in range(0, len(cur), 2):
                a = cur[i]
                bq = cur[i + 1] if i + 1 < len(cur) else cur[i]
                nxt.append(self.mux(bit, bq, a))
            cur = nxt
        assert len(cur) == 1
        return cur[0]


class _PlonkExtAlgebra:
    """The write-once circuit Algebra (cf. stark.HostExtAlgebra /
    DeviceAlgebra) emitting PLONK gates over emulated GF(p^2) values, so
    `ir.eval_gates` defines the in-SNARK OOD identity verbatim."""

    def __init__(self, g: G):
        self.g = g

    def add(self, a, b):
        return self.g.eadd(a, b)

    def sub(self, a, b):
        return self.g.esub(a, b)

    def mul(self, a, b):
        return self.g.emul(a, b)

    def mul_int(self, a, c: int):
        return self.g.escale(a, c % P)

    def add_int(self, a, c: int):
        return self.g.eadd(a, self.g.econst((c % P, 0)))


# ---------------------------------------------------------------------------
# Transcript gadget (mirror of prover/hash_backend.Bn254Transcript)
# ---------------------------------------------------------------------------

class SpongeGadget:
    def __init__(self, g: G):
        self.g = g
        z = g.const_var(0)
        self.state = [z, z, z]
        self.buffer: List[int] = []
        self.squeezed: List[int] = []
        self.read_since_permute = False

    def _permute(self):
        self.state = self.g.b.poseidon2(list(self.state))

    def absorb_vars(self, vals: Sequence[int]):
        """Absorb raw Fr vars (canonical GL vars absorb identically)."""
        self.squeezed = []
        self.read_since_permute = False
        self.buffer.extend(vals)
        while len(self.buffer) >= RATE:
            chunk, self.buffer = self.buffer[:RATE], self.buffer[RATE:]
            self.state = self.g.b.poseidon2(chunk + self.state[RATE:])

    def absorb_gl(self, vals: Sequence[V]):
        vs = []
        for v in vals:
            assert v.bound <= P, "absorbed GL values must be canonical"
            vs.append(v.var if not v.is_const else self.g.const_var(v.cv))
        self.absorb_vars(vs)

    def _flush(self):
        if self.buffer:
            pad = [self.g.const_var(0)] * (RATE - len(self.buffer))
            chunk = self.buffer + pad
            self.buffer = []
            self.state = self.g.b.poseidon2(chunk + self.state[RATE:])

    def squeeze(self) -> int:
        if not self.squeezed:
            self._flush()
            if self.read_since_permute:
                self._permute()
            self.squeezed = list(self.state[:RATE])
            self.read_since_permute = True
        return self.squeezed.pop(0)

    def _split_fr(self, fr: int) -> Tuple[int, int, List[int]]:
        """Decompose an Fr var as lo64 + 2^64*mid64 + 2^128*hi with
        hi <= R>>128 pinned; returns (lo64var, mid64var, lo_bits)."""
        g = self.g
        b = g.b
        lo = b._out(lambda v: v % (1 << 64), (fr,))
        mid = b._out(lambda v: (v >> 64) % (1 << 64), (fr,))
        hi = b._out(lambda v: v >> 128, (fr,))
        lo_bits = g.bits_of(lo, 64)
        g.bits_of(mid, 64)
        g.bits_of(hi, 126)
        # hi <= R_HI: decompose R_HI - hi as 126 bits
        slack = b.lin(R - 1, hi, c0=R_HI)
        g.bits_of(slack, 126)
        # fr = lo + 2^64 mid + 2^128 hi
        t = b.lin(1, lo, 1 << 64, mid)
        b._gate(a=hi, b=t, c=fr, qL=(1 << 128) % R, qR=1, qO=R - 1)
        return lo, mid, lo_bits

    def challenge_ext(self) -> Tuple[EGL, List[int]]:
        """((c0, c1) as GL values, low-64 bit vars of the squeeze)."""
        fr = self.squeeze()
        lo, mid, lo_bits = self._split_fr(fr)
        return ((V(lo, 0, 1 << 64), V(mid, 0, 1 << 64)), lo_bits)

    def query_bits(self, nbits: int) -> List[int]:
        """Position bits for one query: squeeze() % 2^nbits."""
        fr = self.squeeze()
        _lo, _mid, lo_bits = self._split_fr(fr)
        return lo_bits[:nbits]


# ---------------------------------------------------------------------------
# Merkle gadget (mirror of hash_backend.Bn254Backend trees)
# ---------------------------------------------------------------------------

def _leaf_hash(g: G, row: List[V]) -> int:
    """Leaf digest with the host backend's 3-per-Fr GL packing
    (hash_backend.Bn254Backend.pack_row) — injective for canonical values."""
    vals = []
    for v in row:
        assert v.bound <= P
        vals.append(v.var if not v.is_const else g.const_var(v.cv))
    packed = []
    for i in range(0, len(vals), 3):
        tri = vals[i:i + 3]
        fr = tri[0]
        if len(tri) > 1:
            fr = g.b.lin(1, fr, 1 << 64, tri[1])
        if len(tri) > 2:
            fr = g.b.lin(1, fr, (1 << 128) % R, tri[2])
        packed.append(fr)
    return g.b.hash_elements(packed)


def _merkle_check(g: G, leaf_digest: int, idx_bits: List[int],
                  path: List[int], cap: List[int]):
    """Walk the path (depth = len(path)) and assert the result equals the
    cap element selected by the remaining index bits."""
    cur = leaf_digest
    for d, sib in enumerate(path):
        bit = idx_bits[d]
        left = g.mux(bit, sib, cur)
        right = g.mux(bit, cur, sib)
        cur = g.b.hash_elements([left, right])
    rest = idx_bits[len(path):]
    if len(cap) == 1:
        sel = cap[0]
    else:
        need = (len(cap) - 1).bit_length()
        sel = g.mux_tree(list(cap), rest[:need])
    g.b.assert_eq(cur, sel)


# ---------------------------------------------------------------------------
# Circuit layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FwWrapperLayout:
    """Var ids for every witness slot of the wrapper circuit, in the exact
    shapes fill_fw_assignments walks."""
    fw_vk: List[int]
    public_inputs: List[V]
    caps: Dict[str, List[int]]           # tree name -> cap Fr vars
    oods: Dict[str, List[EGL]]           # ood list name -> ext pairs
    final_poly: List[EGL]
    fri_caps: List[List[int]]            # per committed fri layer
    # per query: {tree: (row_lo_vars, row_hi_vars, path_lo, path_hi)}
    query_rows: List[Dict[str, Tuple[List[V], List[V], List[int], List[int]]]]
    fri_leaves: List[List[List[V]]]      # [query][layer][4]
    fri_paths: List[List[List[int]]]     # [query][layer][depth]
    packed_pi: Optional[int]
    meta: dict


_OOD_NAMES = ("witness", "witness_next", "stage2", "stage2_next",
              "stage3", "stage3_next", "table", "const", "sigma", "quotient")


def _tree_layout(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig):
    """(tree name -> row width), n, n_comm, fri config — mirrors
    plonkish._verify_inner's geometry block."""
    n = 1 << ir.log_n
    n_comm = n * cfg.rate
    chunks = pk._copy_chunks(ir.num_witness, ir.copy_chunk)
    n_tables = len(ir.lookup_tables)
    max_deg = max(ir.gate_degree, ir.copy_chunk + 1)
    num_q_chunks = max(1, max_deg - 1)
    s2_width = 2 + 2 * (len(chunks) - 1) + n_tables
    s3_width = (2 + 2 * n_tables + 2 * len(ir.lookup_sets)
                if ir.lookup_sets else 0)
    table_width = sum(np.asarray(t).shape[1] for t in ir.lookup_tables)
    widths = {"witness": ir.num_witness, "stage2": s2_width,
              "quotient": 2 * num_q_chunks,
              "setup": ir.num_const + ir.num_witness + table_width}
    if ir.lookup_sets:
        widths["stage3"] = s3_width
    ood_widths = {
        "witness": ir.num_witness, "witness_next": ir.num_witness,
        "stage2": s2_width, "stage2_next": s2_width,
        "stage3": s3_width, "stage3_next": s3_width,
        "table": table_width, "const": ir.num_const,
        "sigma": ir.num_witness, "quotient": 2 * num_q_chunks}
    return widths, ood_widths, n, n_comm, num_q_chunks


def build_fw_wrapper_circuit(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                             vk_len: int, expose_packed: bool = True
                             ) -> Tuple[pb.PlonkBuilder, FwWrapperLayout]:
    """Build the full verification circuit for a for-wrapper proof of `ir`
    proven under `cfg` with a Bn254Backend whose setup cap has `vk_len`
    entries. Public inputs: [fw_vk..., inner public inputs..., packed]."""
    b = pb.PlonkBuilder()
    g = G(b)
    widths, ood_widths, n, n_comm, num_q_chunks = _tree_layout(ir, cfg)
    fri_cfg = cfg.fri_config(n_comm)
    rounds = fri_cfg.folding_rounds
    h0 = n_comm // 2
    log_h0 = max(h0.bit_length() - 1, 0)
    log_n0 = n_comm.bit_length() - 1
    shift = gl.MULTIPLICATIVE_GENERATOR
    chunks = pk._copy_chunks(ir.num_witness, ir.copy_chunk)
    has_lk = bool(ir.lookup_sets)
    n_tables = len(ir.lookup_tables)
    w_gen = gl.primitive_root_of_unity(ir.log_n)

    # ---- witness slots -----------------------------------------------------
    g.mark("inputs")
    fw_vk = [g.raw_input() for _ in range(vk_len)]
    pis = [g.input_gl() for _ in range(len(ir.public_input_cells))]
    cap_len = {name: min(cfg.cap_size, n_comm)
               for name in ("witness", "stage2", "stage3", "quotient")}
    caps: Dict[str, List[int]] = {}
    for name in ("witness", "stage2", "stage3", "quotient"):
        if name == "stage3" and not has_lk:
            continue
        caps[name] = [g.raw_input() for _ in range(cap_len[name])]
    oods: Dict[str, List[EGL]] = {
        name: [g.input_egl() for _ in range(ood_widths[name])]
        for name in _OOD_NAMES}
    # fri caps: layers 1..rounds-1, each over n_comm >> r pair-leaves
    fri_caps = []
    for r in range(1, rounds):
        n_r = n_comm >> r
        fri_caps.append([g.raw_input()
                         for _ in range(min(fri_cfg.cap_size, n_r // 2))])
    n_f = n_comm >> rounds
    final_poly = [g.input_egl() for _ in range(n_f)]
    # per-query openings
    tree_names = ["witness", "stage2", "quotient", "setup"]
    if has_lk:
        tree_names.insert(2, "stage3")
    tree_depth = {name: (n_comm.bit_length() - 1)
                  - (min(cfg.cap_size, n_comm).bit_length() - 1)
                  for name in tree_names}
    query_rows = []
    fri_leaves = []
    fri_paths = []
    for _q in range(fri_cfg.num_queries):
        rows_q = {}
        for name in tree_names:
            w = widths[name]
            row_lo = [g.input_gl() for _ in range(w)]
            row_hi = [g.input_gl() for _ in range(w)]
            path_lo = [g.raw_input() for _ in range(tree_depth[name])]
            path_hi = [g.raw_input() for _ in range(tree_depth[name])]
            rows_q[name] = (row_lo, row_hi, path_lo, path_hi)
        query_rows.append(rows_q)
        leaves_q = []
        paths_q = []
        for r in range(1, rounds):
            n_r = n_comm >> r
            depth = ((n_r // 2).bit_length() - 1) - \
                (min(fri_cfg.cap_size, n_r // 2).bit_length() - 1)
            leaves_q.append([g.input_gl() for _ in range(4)])
            paths_q.append([g.raw_input() for _ in range(depth)])
        fri_leaves.append(leaves_q)
        fri_paths.append(paths_q)

    # ---- transcript replay ---------------------------------------------------
    g.mark("transcript")
    sp = SpongeGadget(g)
    sp.absorb_vars(fw_vk)
    sp.absorb_gl(pis)
    sp.absorb_vars(caps["witness"])
    beta, _ = sp.challenge_ext()
    gamma, _ = sp.challenge_ext()
    sp.absorb_vars(caps["stage2"])
    theta = beta_lk = None
    if has_lk:
        theta, _ = sp.challenge_ext()
        beta_lk, _ = sp.challenge_ext()
        sp.absorb_vars(caps["stage3"])
    alpha, _ = sp.challenge_ext()
    sp.absorb_vars(caps["quotient"])
    z_pt, _ = sp.challenge_ext()
    flat_oods: List[V] = []
    for name in _OOD_NAMES:
        for (c0, c1) in oods[name]:
            flat_oods.extend([c0, c1])
    sp.absorb_gl(flat_oods)
    gamma_deep, _ = sp.challenge_ext()
    fri_alphas: List[EGL] = []
    for r in range(rounds):
        a_r, _ = sp.challenge_ext()
        fri_alphas.append(a_r)
        if r < rounds - 1:
            sp.absorb_vars(fri_caps[r])
    fp_flat: List[V] = []
    for (c0, c1) in final_poly:
        fp_flat.extend([c0, c1])
    sp.absorb_gl(fp_flat)
    query_pos_bits = [sp.query_bits(log_n0)
                      for _ in range(fri_cfg.num_queries)]

    # ---- OOD identity (plonkish._verify_inner transcription) -----------------
    g.mark("ood_identity")
    alg = _PlonkExtAlgebra(g)
    gate_vals = ir.eval_gates(alg, oods["witness"], oods["witness_next"],
                              oods["const"])
    assert len(gate_vals) == ir.num_gate_constraints

    def pair_ext(lst: List[EGL], i: int) -> EGL:
        return g.eadd(lst[2 * i], g.mul_i(lst[2 * i + 1]))

    z_ext = pair_ext(oods["stage2"], 0)
    z_next = pair_ext(oods["stage2_next"], 0)
    pp_ext = [pair_ext(oods["stage2"], 1 + t_)
              for t_ in range(len(chunks) - 1)]

    ks = gl.powers_host(pk.K_COSET_GEN,
                        max(ir.num_witness, 1)).astype(object)
    copy_vals: List[EGL] = []
    prev = z_ext
    beta_z = g.ereduce(g.emul(beta, z_pt))
    for t_, chunk in enumerate(chunks):
        num_p: EGL = g.econst((1, 0))
        den_p: EGL = g.econst((1, 0))
        for j in chunk:
            w_j = oods["witness"][j]
            id_term = g.eadd(g.eadd(w_j, g.escale(beta_z, int(ks[j]))), gamma)
            sg_term = g.eadd(g.eadd(w_j, g.emul(beta, oods["sigma"][j])),
                             gamma)
            num_p = g.ereduce(g.emul(num_p, id_term))
            den_p = g.ereduce(g.emul(den_p, sg_term))
        nxt = pp_ext[t_] if t_ < len(chunks) - 1 else z_next
        copy_vals.append(g.esub(g.emul(nxt, den_p), g.emul(prev, num_p)))
        prev = pp_ext[t_] if t_ < len(chunks) - 1 else None

    lookup_vals: List[EGL] = []
    s_ext_lk = None
    if has_lk:
        s_ext_lk = pair_ext(oods["stage3"], 0)
        s_next_lk = pair_ext(oods["stage3_next"], 0)
        h_tables = [pair_ext(oods["stage3"], 1 + t_)
                    for t_ in range(n_tables)]
        h_sets = [pair_ext(oods["stage3"], 1 + n_tables + s_)
                  for s_ in range(len(ir.lookup_sets))]
        m_ofs = 2 + 2 * (len(chunks) - 1)
        tslices = pk._table_col_slices(ir)

        def compress_ood(vals: List[EGL]) -> EGL:
            acc = vals[0]
            tp: EGL = g.econst((1, 0))
            for v2 in vals[1:]:
                tp = g.ereduce(g.emul(tp, theta))
                acc = g.eadd(acc, g.emul(tp, v2))
            return acc

        one = g.econst((1, 0))
        for s_, (tbl, cols) in enumerate(ir.lookup_sets):
            a_comp = compress_ood([oods["witness"][c] for c in cols])
            denom = g.ereduce(g.eadd(a_comp, beta_lk))
            lookup_vals.append(g.esub(g.emul(h_sets[s_], denom), one))
        for t_, (start, width) in enumerate(tslices):
            t_comp = compress_ood([oods["table"][start + j]
                                   for j in range(width)])
            denom = g.ereduce(g.eadd(t_comp, beta_lk))
            m_val = oods["stage2"][m_ofs + t_]
            lookup_vals.append(g.esub(g.emul(h_tables[t_], denom), m_val))
        s_trans = g.esub(s_next_lk, s_ext_lk)
        for h in h_sets:
            s_trans = g.esub(s_trans, h)
        for h in h_tables:
            s_trans = g.eadd(s_trans, h)
        lookup_vals.append(s_trans)

    comb: EGL = g.econst((0, 0))
    apow: EGL = g.econst((1, 0))
    for gv in gate_vals + copy_vals + lookup_vals:
        apow = g.emul(apow, alpha)  # lazy: auto-reduces every ~2nd step
        comb = g.eadd(comb, g.emul(apow, g.ereduce(gv)))
        if max(comb[0].bound, comb[1].bound) > (MAXB >> 8):
            comb = g.ereduce(comb)
    zn = g.epow_const_exp(z_pt, n)
    zh = g.esub(zn, g.econst((1, 0)))
    comb = g.ereduce(g.emul(comb, g.einv_hint(zh)))
    apow_b = g.ereduce(g.emul(apow, alpha))
    zm1 = g.esub(z_ext, g.econst((1, 0)))
    zminus1_inv = g.einv_hint(g.esub(z_pt, g.econst((1, 0))))
    comb = g.eadd(comb, g.emul(apow_b, g.ereduce(
        g.emul(zm1, zminus1_inv))))
    if has_lk:
        apow_b = g.ereduce(g.emul(apow_b, alpha))
        comb = g.eadd(comb, g.emul(apow_b, g.ereduce(
            g.emul(s_ext_lk, zminus1_inv))))
    apow_pi = apow_b
    for (col, row), pival in zip(ir.public_input_cells, pis):
        apow_pi = g.ereduce(g.emul(apow_pi, alpha))
        pt = pow(w_gen, row, P)
        num = g.esub(oods["witness"][col], (pival, g.const(0)))
        den_inv = g.einv_hint(g.esub(z_pt, g.econst((pt, 0))))
        comb = g.eadd(comb, g.emul(apow_pi, g.ereduce(
            g.emul(num, den_inv))))
        comb = g.ereduce(comb)

    expected: EGL = g.econst((0, 0))
    zjn: EGL = g.econst((1, 0))
    for j in range(num_q_chunks):
        qz = g.eadd(oods["quotient"][2 * j],
                    g.mul_i(oods["quotient"][2 * j + 1]))
        expected = g.eadd(expected, g.emul(zjn, qz))
        zjn = g.ereduce(g.emul(zjn, zn))
    g.eassert_eq(comb, expected)

    # ---- DEEP gamma powers (shared across queries) ----------------------------
    g.mark("gpows")
    s2_w = ood_widths["stage2"]
    s3_w = ood_widths["stage3"]
    setup_w = ood_widths["const"] + ood_widths["sigma"] + ood_widths["table"]
    n_deep_terms = (2 * ir.num_witness + 2 * s2_w
                    + (2 * s3_w if has_lk else 0)
                    + setup_w + 2 * num_q_chunks)
    gpows: List[EGL] = []
    gp: EGL = g.econst((1, 0))
    for _ in range(n_deep_terms):
        # no explicit reduce: the bound tracker reduces lazily (~every 2nd
        # step) and the reduce-cache dedups the shared gpows across queries
        gp = g.emul(gp, gamma_deep)
        gpows.append(gp)

    zw = g.ereduce(g.emul(z_pt, g.econst((w_gen, 0))))
    ood_setup = oods["const"] + oods["sigma"] + oods["table"]

    # group order mirrors _verify_inner.deep_at
    def deep_groups(rows_at):
        groups = [
            (rows_at("witness"), oods["witness"], "z"),
            (rows_at("witness"), oods["witness_next"], "zw"),
            (rows_at("stage2"), oods["stage2"], "z"),
            (rows_at("stage2"), oods["stage2_next"], "zw"),
        ]
        if has_lk:
            groups.append((rows_at("stage3"), oods["stage3"], "z"))
            groups.append((rows_at("stage3"), oods["stage3_next"], "zw"))
        groups += [
            (rows_at("setup"), ood_setup, "z"),
            (rows_at("quotient"), oods["quotient"], "z"),
        ]
        return groups

    # ---- per-query checks -----------------------------------------------------
    v_gen = gl.primitive_root_of_unity(log_n0)
    w_r = [gl.primitive_root_of_unity(log_n0 - r) for r in range(rounds + 1)]
    shifts = [shift]
    for _ in range(rounds):
        shifts.append((shifts[-1] * shifts[-1]) % P)
    INV2 = pow(2, P - 2, P)

    for qi in range(fri_cfg.num_queries):
        pos_bits = query_pos_bits[qi]
        j0_bits = pos_bits[:log_h0]
        rows_q = query_rows[qi]

        # Merkle membership of both opened rows per tree
        g.mark("merkle")
        for name in tree_names:
            row_lo, row_hi, path_lo, path_hi = rows_q[name]
            cap = caps[name] if name != "setup" else fw_vk
            # low row: index bits = j0 bits (j0 < h0 <= n_comm/2)
            lo_bits = j0_bits + [g.b.zero()] * (log_n0 - log_h0)
            _merkle_check(g, _leaf_hash(g, row_lo), lo_bits, path_lo, cap)
            # high row: index j0 + h0 -> top bit set
            one_bit = g.const_var(1)
            hi_bits = j0_bits + [one_bit] * (log_n0 - log_h0)
            _merkle_check(g, _leaf_hash(g, row_hi), hi_bits, path_hi, cap)

        # DEEP values at x = shift*v^{j0} and x2 = -x (v^{h0} = -1)
        g.mark("deep")
        x_base = g.reduce(g.mul(g.pow_const_base_bits(v_gen, j0_bits),
                                g.const(shift)))
        x_ext: EGL = (x_base, g.const(0))
        x2_ext: EGL = (g.neg(x_base), g.const(0))

        def deep_value(x_e, which):
            inv_xz = g.einv_hint(g.esub(x_e, z_pt))
            inv_xzw = g.einv_hint(g.esub(x_e, zw))

            def rows_at(name):
                row_lo, row_hi, _pl, _ph = rows_q[name]
                return row_lo if which == 0 else row_hi

            acc: EGL = g.econst((0, 0))
            k = 0
            for row, ood_list, den in deep_groups(rows_at):
                gsum: EGL = g.econst((0, 0))
                for j, ood in enumerate(ood_list):
                    num = g.esub((row[j], g.const(0)), ood)
                    gsum = g.eadd(gsum, g.emul(gpows[k], num))
                    k += 1
                gsum = g.ereduce(gsum)
                inv_den = inv_xz if den == "z" else inv_xzw
                acc = g.eadd(acc, g.emul(gsum, inv_den))
            assert k == n_deep_terms
            return g.ereduce(acc)

        a_val = deep_value(x_ext, 0)
        b_val = deep_value(x2_ext, 1)

        # FRI fold-consistency walk (fri.fri_verify transcription)
        g.mark("fri_folds")
        value: Optional[EGL] = None
        for r in range(rounds):
            h_r = (n_comm >> r) // 2
            log_hr = h_r.bit_length() - 1
            if r > 0:
                leaf = fri_leaves[qi][r - 1]
                a_leaf: EGL = (leaf[0], leaf[1])
                b_leaf: EGL = (leaf[2], leaf[3])
                # previous value must equal the component at our position:
                # j_{r-1} < h_r  <=>  bit log_hr of j0 is 0
                sel_bit = j0_bits[log_hr]
                expected_c0 = V(g.mux(sel_bit,
                                      leaf[2].var, leaf[0].var), 0, P)
                expected_c1 = V(g.mux(sel_bit,
                                      leaf[3].var, leaf[1].var), 0, P)
                g.eassert_eq(value, (expected_c0, expected_c1))
                # Merkle check of the pair leaf at index j0 % h_r
                depth = len(fri_paths[qi][r - 1])
                leaf_digest = _leaf_hash(g, list(leaf))
                _merkle_check(g, leaf_digest, j0_bits[:log_hr],
                              fri_paths[qi][r - 1],
                              fri_caps[r - 1])
                a_egl, b_egl = a_leaf, b_leaf
            else:
                a_egl, b_egl = a_val, b_val
            # fold at index j = j0 % h_r of layer r
            d = g.reduce(g.mul(g.pow_const_base_bits(w_r[r],
                                                     j0_bits[:log_hr]),
                               g.const(shifts[r])))
            d_inv = g.inv_hint(d)
            e_term = g.escale(g.eadd(a_egl, b_egl), INV2)
            o_term = g.escale(g.esub(a_egl, b_egl), INV2)
            o_term = (g.reduce(g.mul(o_term[0], d_inv)),
                      g.reduce(g.mul(o_term[1], d_inv)))
            value = g.ereduce(g.eadd(e_term,
                                     g.emul(fri_alphas[r], o_term)))

        # final: value == final_poly(x) at x = shifts[rounds] * w_R^{j0 % n_f}
        log_nf = n_f.bit_length() - 1
        xf = g.reduce(g.mul(g.pow_const_base_bits(w_r[rounds],
                                                  j0_bits[:log_nf]),
                            g.const(shifts[rounds])))
        acc: EGL = g.econst((0, 0))
        for coeff in reversed(final_poly):
            acc = (g.reduce(g.mul(acc[0], xf)), g.reduce(g.mul(acc[1], xf)))
            acc = g.eadd(acc, coeff)
        if value is None:
            value = (a_val[0], a_val[1])  # rounds == 0: DEEP is final
        g.eassert_eq(value, acc)

    # degree bound on the final polynomial (exact zeros, like the host)
    deg_bound = n_f // fri_cfg.lde_factor
    zero = g.b.zero()
    for coeff in final_poly[deg_bound:]:
        g.b.assert_eq(coeff[0].var, zero)
        g.b.assert_eq(coeff[1].var, zero)

    # ---- public outputs -------------------------------------------------------
    packed_var = None
    if expose_packed and len(pis) >= 4:
        from ..prover.compression import _CHUNK_BITS
        sh = 1 << _CHUNK_BITS
        last4 = pis[-4:]
        t1 = b.lin(sh, last4[0].var, 1, last4[1].var)
        t2 = b.lin(sh, t1, 1, last4[2].var)
        packed_var = b.lin(sh, t2, 1, last4[3].var)
    for v in fw_vk:
        b.mark_public(v)
    for v in pis:
        b.mark_public(v.var)
    if packed_var is not None:
        b.mark_public(packed_var)

    lay = FwWrapperLayout(
        fw_vk=fw_vk, public_inputs=pis, caps=caps, oods=oods,
        final_poly=final_poly, fri_caps=fri_caps, query_rows=query_rows,
        fri_leaves=fri_leaves, fri_paths=fri_paths, packed_pi=packed_var,
        meta=dict(vk_len=vk_len, rounds=rounds, n_comm=n_comm,
                  tree_names=tree_names, num_queries=fri_cfg.num_queries,
                  n_gates=len(b.qL), n_reductions=g.n_reductions,
                  sections=g.section_gates()))
    return b, lay


# ---------------------------------------------------------------------------
# Witness fill from a concrete for-wrapper proof
# ---------------------------------------------------------------------------

def fill_fw_assignments(lay: FwWrapperLayout, ir: pk.PlonkishIR,
                        cfg: pk.PlonkishConfig, fw_vk: Sequence[int],
                        proof: pk.PlonkishProof) -> Dict[int, int]:
    """Map a concrete proof into the circuit's input vars."""
    asg: Dict[int, int] = {}
    for var, v in zip(lay.fw_vk, fw_vk):
        asg[var] = int(v) % R
    for pv, v in zip(lay.public_inputs, proof.public_inputs):
        asg[pv.var] = int(v) % P

    def put_cap(vars_, cap):
        flat = [int(v) for v in np.asarray(cap, dtype=object).ravel()]
        assert len(flat) == len(vars_), (len(flat), len(vars_))
        for var, v in zip(vars_, flat):
            asg[var] = v % R

    put_cap(lay.caps["witness"], proof.witness_cap)
    put_cap(lay.caps["stage2"], proof.stage2_cap)
    if "stage3" in lay.caps:
        put_cap(lay.caps["stage3"], proof.stage3_cap)
    put_cap(lay.caps["quotient"], proof.quotient_cap)

    ood_src = {"witness": proof.ood_witness,
               "witness_next": proof.ood_witness_next,
               "stage2": proof.ood_stage2,
               "stage2_next": proof.ood_stage2_next,
               "stage3": proof.ood_stage3,
               "stage3_next": proof.ood_stage3_next,
               "table": proof.ood_table, "const": proof.ood_const,
               "sigma": proof.ood_sigma, "quotient": proof.ood_quotient}
    for name in _OOD_NAMES:
        pairs = ood_src[name]
        assert len(pairs) == len(lay.oods[name])
        for (v0, v1), (p0, p1) in zip(pairs, lay.oods[name]):
            asg[p0.var] = int(v0) % P
            asg[p1.var] = int(v1) % P

    fri = proof.fri
    for cap_vars, cap in zip(lay.fri_caps, fri.caps):
        put_cap(cap_vars, cap)
    assert len(fri.final_poly) == len(lay.final_poly)
    for (c0, c1), (p0, p1) in zip(fri.final_poly, lay.final_poly):
        asg[p0.var] = int(c0) % P
        asg[p1.var] = int(c1) % P

    n_comm = lay.meta["n_comm"]
    h0 = n_comm // 2
    positions = [int(p) for p in fri.query_positions]
    assert len(positions) == lay.meta["num_queries"]
    for qi, p0_ in enumerate(positions):
        j0 = p0_ % h0
        for name in lay.meta["tree_names"]:
            row_lo, row_hi, path_lo, path_hi = lay.query_rows[qi][name]
            vals_lo = proof.openings[name][j0]
            vals_hi = proof.openings[name][j0 + h0]
            for var_v, v in zip(row_lo, vals_lo):
                asg[var_v.var] = int(v) % P
            for var_v, v in zip(row_hi, vals_hi):
                asg[var_v.var] = int(v) % P
            p_lo = np.asarray(proof.paths[name][j0], dtype=object).ravel()
            p_hi = np.asarray(proof.paths[name][j0 + h0],
                              dtype=object).ravel()
            assert len(p_lo) == len(path_lo), (len(p_lo), len(path_lo))
            for var, v in zip(path_lo, p_lo):
                asg[var] = int(v) % R
            for var, v in zip(path_hi, p_hi):
                asg[var] = int(v) % R
        for r in range(1, lay.meta["rounds"]):
            n_r = n_comm >> r
            leaf_idx = (p0_ % n_r) % (n_r // 2)
            op = fri.openings[r - 1]
            for var_v, v in zip(lay.fri_leaves[qi][r - 1], op.leaves[qi]):
                asg[var_v.var] = int(v) % P
            path = np.asarray(op.paths[qi], dtype=object).ravel()
            assert len(path) == len(lay.fri_paths[qi][r - 1])
            for var, v in zip(lay.fri_paths[qi][r - 1], path):
                asg[var] = int(v) % R
            del leaf_idx
    return asg


# ---------------------------------------------------------------------------
# Top-level prove/verify surface
# ---------------------------------------------------------------------------

_BUILD_CACHE: Dict = {}


def _circuit_key(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig, vk_len: int):
    return (id(ir), cfg.rate, cfg.cap_size, cfg.num_queries,
            cfg.final_fri_size, vk_len)


def build_cached(ir, cfg, vk_len):
    key = _circuit_key(ir, cfg, vk_len)
    if key not in _BUILD_CACHE:
        b, lay = build_fw_wrapper_circuit(ir, cfg, vk_len)
        circ = b.finalize()
        _BUILD_CACHE[key] = (b, lay, circ)
    return _BUILD_CACHE[key]


def wrap_fw_proof(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                  fw_vk: Sequence[int], proof: pk.PlonkishProof,
                  crs=None, g2_powers=None):
    """PLONK-prove the in-SNARK verification of a for-wrapper proof.
    Returns (plonk_setup, plonk_proof, layout)."""
    b, lay, circ = build_cached(ir, cfg, len(list(fw_vk)))
    setup = pl.plonk_setup(circ, crs, g2_powers)
    asg = fill_fw_assignments(lay, ir, cfg, fw_vk, proof)
    wires, pis = b.fill(asg)
    snark = pl.plonk_prove(setup, wires, pis)
    return setup, snark, lay


def verify_fw_wrapped(vk: pl.PlonkVerificationKey, snark: pl.PlonkProof,
                      expected_fw_vk: Optional[Sequence[int]] = None,
                      expected_inner_pis: Optional[Sequence[int]] = None
                      ) -> bool:
    """PLONK-verify + pin the exposed fw_vk / inner PIs / packed value."""
    from ..prover.compression import compress_stark_pi_to_snark_pi
    pis = [int(v) for v in snark.public_inputs]
    if expected_fw_vk is not None:
        k = len(list(expected_fw_vk))
        if pis[:k] != [int(v) % R for v in expected_fw_vk]:
            return False
        rest = pis[k:]
        if expected_inner_pis is not None:
            m = len(list(expected_inner_pis))
            if rest[:m] != [int(v) % P for v in expected_inner_pis]:
                return False
            if len(rest) == m + 1 and m >= 4:
                if rest[m] != compress_stark_pi_to_snark_pi(rest[m - 4:m]):
                    return False
    return pl.plonk_verify(vk, snark)


def gate_check_fw(ir: pk.PlonkishIR, cfg: pk.PlonkishConfig,
                  fw_vk: Sequence[int], proof: pk.PlonkishProof) -> dict:
    """Fill + check every gate equation (fast structural check without the
    PLONK prove). Returns circuit stats. Raises on any violated gate."""
    b, lay, _circ = build_cached(ir, cfg, len(list(fw_vk)))
    asg = fill_fw_assignments(lay, ir, cfg, fw_vk, proof)
    wires, pis = b.fill(asg)
    wa, wb, wc = wires
    pi_by_gate = dict(zip(b.public_gates, pis))
    bad = []
    for gi in range(len(b.qL)):
        val = (b.qM[gi] * wa[gi] * wb[gi] + b.qL[gi] * wa[gi]
               + b.qR[gi] * wb[gi] + b.qO[gi] * wc[gi] + b.qC[gi]
               - pi_by_gate.get(gi, 0)) % R
        if val:
            bad.append(gi)
            if len(bad) > 16:
                break
    if bad:
        raise AssertionError(f"violated gates: {bad[:16]}"
                             f" (of {len(b.qL)})")
    return dict(n_gates=len(b.qL), public_inputs=pis,
                **{k: v for k, v in lay.meta.items()
                   if k in ("n_reductions", "sections")})
