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
    """Constraints over base-field tensors (a whole coset at once).

    `stacks_tiles`: a circuit built from repeated column tiles (the sponge
    tiles of circuits/narrow_region.py and the RAM permutation) may evaluate
    all its tiles at once, each lane stacked into one (tiles, n) tensor, so
    that an operation is one launch for every tile; the constraint values and
    their order are those of the tile-by-tile loop. The host algebras
    evaluate tile by tile."""

    stacks_tiles = True

    def __init__(self):
        self._consts = {}  # (value, device) -> 0-d field tensor

    def _const(self, c: int, like):
        key = (c % P, like.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = gl.scalar_like(c, like)
        return t

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_int(self, a, c: int):
        return gl.mul(a, self._const(c, a))

    def add_int(self, a, c: int):
        return gl.add(a, self._const(c, a))


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
