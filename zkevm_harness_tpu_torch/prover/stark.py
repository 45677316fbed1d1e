"""Algebra adapters: one constraint definition, two evaluation modes.

Counterpart of the adapters in the JAX package's `prover/stark.py`.
Constraints are written once against an `Algebra` and evaluated both on the
device (base-field tensors over a whole coset) and on the host (exact ext
ints at the OOD point). The AIR STARK engine of that module is not ported
yet.
"""

from __future__ import annotations

from ..ops import goldilocks as gl
from ..ops.goldilocks import P
from ..utils import field_int as fi


class DeviceAlgebra:
    """Constraints over base-field tensors (a whole coset at once)."""

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_int(self, a, c: int):
        return gl.mul(a, gl.scalar_like(c % P, a))

    def add_int(self, a, c: int):
        return gl.add(a, gl.scalar_like(c % P, a))


class HostExtAlgebra:
    """Constraints over exact ext-int tuples (OOD point evaluation)."""

    def add(self, a, b):
        return fi.eadd(a, b)

    def sub(self, a, b):
        return fi.esub(a, b)

    def mul(self, a, b):
        return fi.emul(a, b)

    def mul_int(self, a, c: int):
        return fi.escale(a, c % P)

    def add_int(self, a, c: int):
        return fi.eadd(a, (c % P, 0))
