"""Tiny PLONK gadget builder: arithmetic DAGs -> utils/plonk.py circuits.

The BN254-side counterpart of circuits/builder.py: the SNARK wrapper's
statement (verify/bind the compression-for-wrapper proof) is a PROGRAM
lowered onto PLONK gates (qM*a*b + qL*a + qR*b + qO*c + qC = 0 with copy
wires). Includes the Poseidon2-BN254 permutation as a gadget (3 gates per
x^5 S-box by folding the round constant into the square chain) — the
native-field hash the reference's WrapperCircuit uses
(snark_wrapper's CircuitPoseidon2Sponge, proof_wrapper_utils/mod.rs:30-31).

Counterpart of the JAX package's `utils/plonk_builder.py`, moved across as
it is (host Python ints over the port's `utils/plonk.py` and
`utils/poseidon2_bn254.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import plonk as pl
from .bn254 import R
from .poseidon2_bn254 import RATE, T, get_params_bn254


class PlonkBuilder:
    def __init__(self):
        self.qL: List[int] = []
        self.qR: List[int] = []
        self.qO: List[int] = []
        self.qM: List[int] = []
        self.qC: List[int] = []
        self.wa: List[int] = []
        self.wb: List[int] = []
        self.wc: List[int] = []
        self._next_class = 0
        self._next_unused = -1
        self.public_gates: List[int] = []
        self.public_vars: List[int] = []
        # witness evaluation plan: var -> ("input",) | ("gate", fn, deps)
        self._plan: Dict[int, Tuple] = {}
        self._zero: Optional[int] = None

    # -- variables ----------------------------------------------------------

    def _var(self) -> int:
        v = self._next_class
        self._next_class += 1
        return v

    def input(self) -> int:
        v = self._var()
        self._plan[v] = ("input",)
        return v

    def inputs(self, k: int) -> List[int]:
        return [self.input() for _ in range(k)]

    def _unused(self) -> int:
        u = self._next_unused
        self._next_unused -= 1
        return u

    def zero(self) -> int:
        if self._zero is None:
            z = self._var()
            self._plan[z] = ("gate", lambda: 0, ())
            self._gate(a=z, qL=1)  # 1*z = 0
            self._zero = z
        return self._zero

    # -- gates ----------------------------------------------------------------

    def _gate(self, a: Optional[int] = None, b: Optional[int] = None,
              c: Optional[int] = None, qL: int = 0, qR: int = 0,
              qO: int = 0, qM: int = 0, qC: int = 0):
        self.qL.append(qL % R)
        self.qR.append(qR % R)
        self.qO.append(qO % R)
        self.qM.append(qM % R)
        self.qC.append(qC % R)
        self.wa.append(a if a is not None else self._unused())
        self.wb.append(b if b is not None else self._unused())
        self.wc.append(c if c is not None else self._unused())

    def _out(self, fn: Callable, deps: Tuple[int, ...]) -> int:
        v = self._var()
        self._plan[v] = ("gate", fn, deps)
        return v

    def add(self, x: int, y: int) -> int:
        z = self._out(lambda vx, vy: (vx + vy) % R, (x, y))
        self._gate(a=x, b=y, c=z, qL=1, qR=1, qO=R - 1)
        return z

    def lin(self, cx: int, x: int, cy: int = 0, y: Optional[int] = None,
            c0: int = 0) -> int:
        """z = cx*x + cy*y + c0."""
        if y is None:
            z = self._out(lambda vx: (cx * vx + c0) % R, (x,))
            self._gate(a=x, c=z, qL=cx, qO=R - 1, qC=c0)
        else:
            z = self._out(lambda vx, vy: (cx * vx + cy * vy + c0) % R,
                          (x, y))
            self._gate(a=x, b=y, c=z, qL=cx, qR=cy, qO=R - 1, qC=c0)
        return z

    def mul(self, x: int, y: int) -> int:
        z = self._out(lambda vx, vy: (vx * vy) % R, (x, y))
        self._gate(a=x, b=y, c=z, qM=1, qO=R - 1)
        return z

    def assert_eq(self, x: int, y: int):
        self._gate(a=x, b=y, qL=1, qR=R - 1)

    def mark_public(self, x: int):
        """Expose x as a public input (a public gate qL=1: a - PI = 0)."""
        self.public_gates.append(len(self.qL))
        self.public_vars.append(x)
        self._gate(a=x, qL=1)

    # -- Poseidon2-BN254 gadget ----------------------------------------------

    def _sbox(self, x: int, rc: int) -> int:
        """(x + rc)^5 in 3 gates: s2 = x^2+2rc*x+rc^2; s4 = s2^2;
        s5 = s4*x + rc*s4."""
        rc %= R
        s2 = self._out(lambda vx: pow(vx + rc, 2, R), (x,))
        self._gate(a=x, b=x, c=s2, qM=1, qL=2 * rc, qO=R - 1,
                   qC=rc * rc % R)
        s4 = self.mul(s2, s2)
        s5 = self._out(lambda vx: pow(vx + rc, 5, R), (x,))
        # qM*s4*x + qL*s4 - s5 = 0 with qL = rc
        self._gate(a=s4, b=x, c=s5, qM=1, qL=rc, qO=R - 1)
        return s5

    def _m_external(self, s: List[int]) -> List[int]:
        t01 = self.add(s[0], s[1])
        tot = self.add(t01, s[2])
        return [self.add(x, tot) for x in s]

    def _m_internal(self, s: List[int], diag: Sequence[int]) -> List[int]:
        t01 = self.add(s[0], s[1])
        tot = self.add(t01, s[2])
        return [self.lin(int(d), x, 1, tot) for x, d in zip(s, diag)]

    def poseidon2(self, state: List[int]) -> List[int]:
        p = get_params_bn254()
        assert len(state) == T
        s = self._m_external(list(state))
        for rc in p["external_initial"]:
            s = [self._sbox(x, int(c)) for x, c in zip(s, rc)]
            s = self._m_external(s)
        for c in p["internal"]:
            s = [self._sbox(s[0], int(c))] + s[1:]
            s = self._m_internal(s, [int(d) for d in p["internal_diag"]])
        for rc in p["external_final"]:
            s = [self._sbox(x, int(c)) for x, c in zip(s, rc)]
            s = self._m_external(s)
        return s

    def hash_elements(self, vals: List[int]) -> int:
        """Sponge hash gadget (overwrite mode, rate 2) matching
        poseidon2_bn254.hash_elements."""
        vals = list(vals)
        if len(vals) % RATE:
            vals = vals + [self.zero()] * (RATE - len(vals) % RATE)
        state = [self.zero()] * T
        for i in range(0, len(vals), RATE):
            state = self.poseidon2(vals[i:i + RATE] + state[RATE:])
        return state[0]

    # -- finalize / fill -------------------------------------------------------

    def finalize(self) -> pl.PlonkCircuit:
        return pl.PlonkCircuit(
            num_gates=len(self.qL), qL=list(self.qL), qR=list(self.qR),
            qO=list(self.qO), qM=list(self.qM), qC=list(self.qC),
            wires=(list(self.wa), list(self.wb), list(self.wc)),
            public_gates=list(self.public_gates))

    def fill(self, assignments: Dict[int, int]
             ) -> Tuple[Tuple[List[int], List[int], List[int]], List[int]]:
        """Evaluate the plan on concrete inputs; returns (wire value
        vectors, public input values). Iterative (explicit stack): gadget
        circuits chain hundreds of thousands of dependent vars — the
        in-SNARK FRI verifier's sponge/reduction chains exceed any Python
        recursion limit."""
        vals: Dict[int, int] = {}

        def ev(v: int) -> int:
            if v in vals:
                return vals[v]
            stack = [v]
            while stack:
                cur = stack[-1]
                if cur in vals:
                    stack.pop()
                    continue
                kind = self._plan[cur]
                if kind[0] == "input":
                    vals[cur] = int(assignments[cur]) % R
                    stack.pop()
                    continue
                _k, fn, deps = kind
                missing = [d for d in deps if d not in vals]
                if missing:
                    stack.extend(missing)
                    continue
                vals[cur] = int(fn(*(vals[d] for d in deps))) % R
                stack.pop()
            return vals[v]

        def wirevals(col: List[int]) -> List[int]:
            return [ev(w) if w >= 0 else 0 for w in col]

        wa = wirevals(self.wa)
        wb = wirevals(self.wb)
        wc = wirevals(self.wc)
        pis = [ev(v) for v in self.public_vars]
        return (wa, wb, wc), pis
