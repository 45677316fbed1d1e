"""ECRecover circuit (type 7): the ECDSA recovery equation proven in Fp.

The reference circuit (zkevm_circuits ecrecover, capacity
cycles_per_ecrecover_circuit) checks secp256k1 signature recovery with
boojum's non-native gadgets. This module proves the same statement on the
foreign-field row core (circuits/ffarith.py), ONE field only:

    s*R  ==  r*Q + h*G          (so Q = r^{-1}(s*R - h*G))

  - the recovered point Q and the lifted point R = (r, y_R) are witnessed
    in projective coordinates and constrained on-curve (Y^2*Z = X^3 + 7*Z^3
    checked affinely after normalization: R enters affine with X pinned to
    the signature's r);
  - scalar multiplications run as a SHARED double-and-add (Shamir) over
    the three points (R, -Q, -G) with complete Renes-Costello projective
    addition/doubling formulas (a = 0, algorithms 7/9) — no inversions, no
    exceptional cases, every step a handful of mulmod rows;
  - scalar bits are boolean rows recombined integer-exactly
    (s, r, h < n < p so the recombination holds over Z);
  - the result must be the identity (Z == 0 pinned by constraint);
  - public inputs: the limbs of h, r, s, and Q's affine coordinates — the
    aggregation layer's PI commitments bind them to the log queue, and the
    recovered ADDRESS is keccak(Q) via the type-5/13 keccak core.

Supports any short-Weierstrass curve with a = 0 (tests use a 64-bit toy
curve so the CPU suite stays fast; production instantiates secp256k1 at
u8 limbs / 2^8 range table, `prover/layers.py`).

Counterpart of the JAX package's `circuits/ecrecover_circuit.py`, as it is
but for `ecrecover_witness`, which takes `device` (`None`: the CUDA card,
raising where there is none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..ops import goldilocks as gl
from . import ffarith as ff

P = gl.P

SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
          0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


@dataclasses.dataclass(frozen=True)
class CurveParams:
    p: int                      # base field modulus
    b: int                      # y^2 = x^3 + b
    g: Tuple[int, int]          # generator (affine)
    scalar_bits: int            # bits per scalar in-circuit
    limb_bits: int = 16

    @property
    def b3(self) -> int:
        return 3 * self.b % self.p


def secp256k1_params(limb_bits: int = 16) -> CurveParams:
    return CurveParams(p=SECP_P, b=7, g=SECP_G, scalar_bits=256,
                       limb_bits=limb_bits)


# ---------------------------------------------------------------------------
# Host-side projective point math (mirror of the in-circuit formulas)
# ---------------------------------------------------------------------------

def padd_host(c: CurveParams, P1, P2):
    """Complete projective addition (Renes-Costello alg 7, a=0)."""
    p, b3 = c.p, c.b3
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    t0 = X1 * X2 % p
    t1 = Y1 * Y2 % p
    t2 = Z1 * Z2 % p
    t3 = (X1 + Y1) * (X2 + Y2) % p
    t3 = (t3 - t0 - t1) % p
    t4 = (Y1 + Z1) * (Y2 + Z2) % p
    t4 = (t4 - t1 - t2) % p
    t5 = (X1 + Z1) * (X2 + Z2) % p
    t5 = (t5 - t0 - t2) % p
    t6 = 3 * t0 % p
    t2b = b3 * t2 % p
    z3t = (t1 + t2b) % p
    t1b = (t1 - t2b) % p
    y3 = b3 * t5 % p
    X3 = (t3 * t1b - t4 * y3) % p
    Y3 = (y3 * t6 + t1b * z3t) % p
    Z3 = (z3t * t4 + t3 * t6) % p
    return (X3 % p, Y3 % p, Z3 % p)


def pdbl_host(c: CurveParams, P1):
    return padd_host(c, P1, P1)


def pmul_host(c: CurveParams, k: int, pt_affine: Tuple[int, int]):
    acc = (0, 1, 0)
    base = (pt_affine[0], pt_affine[1], 1)
    for bit in reversed(range(c.scalar_bits)):
        acc = pdbl_host(c, acc)
        if (k >> bit) & 1:
            acc = padd_host(c, acc, base)
    return acc


def to_affine_host(c: CurveParams, pt) -> Optional[Tuple[int, int]]:
    X, Y, Z = pt
    if Z % c.p == 0:
        return None
    zi = pow(Z, c.p - 2, c.p)
    return (X * zi % c.p, Y * zi % c.p)


# ---------------------------------------------------------------------------
# In-circuit EC program
# ---------------------------------------------------------------------------

class ECBuilder:
    """Emits ffarith rows for projective point ops. Points are (X, Y, Z)
    triples of FFVars."""

    def __init__(self, prog: ff.FFProgram, curve: CurveParams):
        self.prog = prog
        self.c = curve

    def _sub(self, x: ff.FFVar, y: ff.FFVar) -> ff.FFVar:
        # x - y = y*(M-1) + x
        return self.prog.fma_const(y, self.c.p - 1, x)

    def padd(self, P1, P2):
        """Complete addition, mirrors padd_host exactly."""
        pr, c = self.prog, self.c
        X1, Y1, Z1 = P1
        X2, Y2, Z2 = P2
        t0 = pr.mul(X1, X2)
        t1 = pr.mul(Y1, Y2)
        t2 = pr.mul(Z1, Z2)
        sx1 = pr.add(X1, Y1)
        sx2 = pr.add(X2, Y2)
        t3 = pr.mul(sx1, sx2)
        t3 = self._sub(t3, t0)
        t3 = self._sub(t3, t1)
        sy1 = pr.add(Y1, Z1)
        sy2 = pr.add(Y2, Z2)
        t4 = pr.mul(sy1, sy2)
        t4 = self._sub(t4, t1)
        t4 = self._sub(t4, t2)
        sz1 = pr.add(X1, Z1)
        sz2 = pr.add(X2, Z2)
        t5 = pr.mul(sz1, sz2)
        t5 = self._sub(t5, t0)
        t5 = self._sub(t5, t2)
        t6 = pr.mul_const(t0, 3)
        t2b = pr.mul_const(t2, c.b3)
        z3t = pr.add(t1, t2b)
        t1b = self._sub(t1, t2b)
        y3 = pr.mul_const(t5, c.b3)
        X3 = self._sub(pr.mul(t3, t1b), pr.mul(t4, y3))
        Y3 = pr.fma(t1b, z3t, pr.mul(y3, t6))
        Z3 = pr.fma(t3, t6, pr.mul(z3t, t4))
        return (X3, Y3, Z3)

    def select(self, bit: ff.FFVar, pt_if_1, pt_if_0):
        """Coordinate-wise: out = pt0 + bit*(pt1 - pt0)."""
        out = []
        for a, b in zip(pt_if_1, pt_if_0):
            d = self._sub(a, b)
            out.append(self.prog.fma(bit, d, b))
        return tuple(out)

    def constant_point(self, pt: Tuple[int, int, int]):
        pr = self.prog
        return tuple(pr.add_const(pr.zero(), v) for v in pt)


@dataclasses.dataclass
class EcrecoverProgram:
    curve: CurveParams
    layout: ff.FFLayout
    h_row: int
    r_row: int
    s_row: int
    qx_row: int
    qy_row: int
    ry_row: int
    h_bits: List[int]
    r_bits: List[int]
    s_bits: List[int]


def build_ecrecover_program(curve: CurveParams) -> EcrecoverProgram:
    par = ff.FFParams(modulus=curve.p, limb_bits=curve.limb_bits,
                      num_limbs=-(-max(curve.p.bit_length(), 8)
                                  // curve.limb_bits))
    prog = ff.FFProgram(par)
    ec = ECBuilder(prog, curve)
    p = curve.p

    h = prog.input()
    r = prog.input()
    s = prog.input()
    qx = prog.input()
    qy = prog.input()
    ry = prog.input()   # y-coordinate of the lifted R point

    # on-curve checks (affine): y^2 == x^3 + b
    def on_curve(x, y):
        y2 = prog.mul(y, y)
        x2 = prog.mul(x, x)
        x3 = prog.mul(x2, x)
        rhs = prog.add_const(x3, curve.b)
        diff = ec._sub(y2, rhs)
        prog.rows[diff.row]["r_const"] = 0  # pin to zero
        return diff

    on_curve(qx, qy)
    on_curve(r, ry)

    # scalar bit decompositions, recombined integer-exactly
    def decompose(scalar_var):
        bits = []
        for _ in range(curve.scalar_bits):
            bits.append(prog.boolean())
        acc = prog.zero()
        for b in reversed(bits):  # MSB-first recombination
            acc = prog.fma_const(acc, 2, b)
        prog.assert_eq(acc, scalar_var)
        return bits  # bits[i] = bit i (LSB first)

    h_bits = decompose(h)
    r_bits = decompose(r)
    s_bits = decompose(s)

    # negated points: -Q = (qx, -qy), -G = (gx, -gy)
    one = prog.add_const(prog.zero(), 1)
    nqy = prog.fma_const(qy, p - 1, None)
    negQ = (qx, nqy, one)
    Rpt = (r, ry, one)
    gx, gy = curve.g
    negG = ec.constant_point((gx, (p - gy) % p, 1))

    # Shamir: T = s*R - r*Q - h*G, checked == identity
    acc = (prog.zero(), one, prog.zero())
    for bit in reversed(range(curve.scalar_bits)):
        acc = ec.padd(acc, acc)   # complete double via add(P,P)
        with_r = ec.padd(acc, Rpt)
        acc = ec.select(s_bits[bit], with_r, acc)
        with_q = ec.padd(acc, negQ)
        acc = ec.select(r_bits[bit], with_q, acc)
        with_g = ec.padd(acc, negG)
        acc = ec.select(h_bits[bit], with_g, acc)

    # identity: the complete formulas land on (0 : Y : 0) iff the sum is
    # the group identity — pin Z to zero
    prog.rows[acc[2].row]["r_const"] = 0

    layout = ff.build_ff_layout(
        prog, public_results=(h, r, s, qx, qy))
    return EcrecoverProgram(curve=curve, layout=layout,
                            h_row=h.row, r_row=r.row, s_row=s.row,
                            qx_row=qx.row, qy_row=qy.row, ry_row=ry.row,
                            h_bits=[b.row for b in h_bits],
                            r_bits=[b.row for b in r_bits],
                            s_bits=[b.row for b in s_bits])


def ecrecover_witness(eprog: EcrecoverProgram, ir, h: int, r: int, s: int,
                      q: Tuple[int, int], ry: int, device=None) -> gl.GF:
    """Fill the program for one recovery: the witnessed Q must satisfy
    s*R == r*Q + h*G (i.e. Q = r^{-1}(s*R - h*G)) and R=(r,ry) on-curve."""
    c = eprog.curve
    inputs: Dict[Tuple[int, str], int] = {
        (eprog.h_row, "A"): int(h) % c.p,
        (eprog.r_row, "A"): int(r) % c.p,
        (eprog.s_row, "A"): int(s) % c.p,
        (eprog.qx_row, "A"): int(q[0]) % c.p,
        (eprog.qy_row, "A"): int(q[1]) % c.p,
        (eprog.ry_row, "A"): int(ry) % c.p,
    }
    for i, brow in enumerate(eprog.h_bits):
        inputs[(brow, "A")] = (int(h) >> i) & 1
    for i, brow in enumerate(eprog.r_bits):
        inputs[(brow, "A")] = (int(r) >> i) & 1
    for i, brow in enumerate(eprog.s_bits):
        inputs[(brow, "A")] = (int(s) >> i) & 1
    return ff.ff_witness(eprog.layout, ir, inputs, device=device)


def expected_public_inputs(eprog: EcrecoverProgram, h: int, r: int, s: int,
                           q: Tuple[int, int]) -> List[int]:
    par = eprog.layout.params
    out: List[int] = []
    for v in (h, r, s, q[0], q[1]):
        out += par.split(int(v) % eprog.curve.p)
    return out
