"""Distributed NTT: one polynomial's DOMAIN sharded over the ranks.

Counterpart of the JAX package's `parallel/dist_ntt.py`, run inside every
rank of `parallel.mesh.run_on_mesh` on the rank's contiguous slice of the
evaluation domain. A four-step NTT whose global transposes are
`all_to_all_single` exchanges.

Algorithm (N = N1*N2, natural-order input x[n], n = n1*N2 + n2):
  1. all-to-all transpose: the rank gets all n1 for its n2 slice,
  2. local NTT of length N1 (the column transforms),
  3. twiddle scaling by w_N^{n2*k1} (the rank's rows of the table),
  4. all-to-all transpose back, local NTT of length N2,
  5. final all-to-all transpose so the output is natural-order sharded.

Each JAX `all_to_all(split_axis, concat_axis, tiled=True)` becomes one
`all_to_all_single` along dim 0: the split axis is cut into D parts moved to
the front (made contiguous) before the exchange, and the D received parts
are moved into the concat axis after it (`_all_to_all`).
"""

from __future__ import annotations

import functools

import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nt
from ..ops.goldilocks import GF
from .mesh import Mesh, all_to_all


@functools.lru_cache(maxsize=None)
def _split(n: int):
    """N = N1 * N2 with N1 <= N2, both powers of two."""
    log_n = n.bit_length() - 1
    l1 = log_n // 2
    return 1 << l1, 1 << (log_n - l1)


def _twiddle_table(n: int, rows: range, device) -> GF:
    """tw[n2, k1] = w_N^{n2*k1} for n2 in `rows` (a contiguous range of
    length a power of two), as (len(rows), N1), built on `device`.

    Row r0 is [w^{r0 k1}]_k1; doubling appends rows r0 + m .. r0 + 2m - 1 as
    the first m times [w^{m k1}]_k1. Field arithmetic is exact, so this
    equals the JAX package's host table bit for bit."""
    n1, _n2 = _split(n)
    w = gl.primitive_root_of_unity(n.bit_length() - 1)
    tab = gl.powers_dev_cached(pow(w, rows.start, gl.P), n1,
                               device=device)[None]
    while tab.shape[0] < len(rows):
        m = tab.shape[0]
        step = gl.powers_dev_cached(pow(w, m, gl.P), n1, device=device)
        tab = torch.cat([tab, gl.mul(tab, step[None])])
    return tab


def _all_to_all(x: GF, split_axis: int, concat_axis: int, mesh: Mesh) -> GF:
    """JAX's tiled `all_to_all(x, split_axis, concat_axis)` over the mesh:
    part j of `split_axis` goes to rank j; the parts received from ranks
    0 .. D-1 are concatenated along `concat_axis`."""
    d = mesh.size
    shp = list(x.shape)
    parts = x.reshape(shp[:split_axis] + [d, shp[split_axis] // d]
                      + shp[split_axis + 1:]).movedim(split_axis, 0)
    got = all_to_all(parts, mesh)  # (D, *local shape with split / D)
    loc = list(got.shape[1:])
    out = got.movedim(0, concat_axis)
    loc[concat_axis] *= d
    return out.reshape(loc)


def distributed_ntt(values: GF, mesh: Mesh) -> GF:
    """values: the rank's (C, N/D) slice of a natural-order (C, N) array
    sharded over the domain; returns the rank's slice of the NTT, sharded
    the same way."""
    c, n_loc = values.shape
    d = mesh.size
    n = n_loc * d
    n1, n2 = _split(n)
    assert n1 % d == 0 and n2 % d == 0, "device count must divide both factors"
    r = mesh.rank
    tw = _twiddle_table(n, range(r * (n2 // d), (r + 1) * (n2 // d)),
                        values.device)
    loc = values.reshape(c, n1 // d, n2)
    # transpose 1: -> (C, N1, N2/D): all n1 local, n2 sharded
    loc = _all_to_all(loc, 2, 1, mesh)
    # local column NTTs (length N1): move n1 to the last axis
    y = nt.ntt(loc.transpose(1, 2))  # (C, N2/D, N1) = Y[n2_loc, k1]
    y = gl.mul(y, tw[None])
    # transpose 2: split k1, concat n2 -> (C, N2, N1/D)
    y = _all_to_all(y, 2, 1, mesh)
    # local row NTTs (length N2) for each k1
    z = nt.ntt(y.transpose(1, 2))  # (C, N1/D, N2) = Z[k1_loc, k2]
    # transpose 3: natural order X[k1 + N1 k2]: shard k2, keep all k1
    z = _all_to_all(z, 2, 1, mesh)  # (C, N1, N2/D)
    return z.transpose(1, 2).reshape(c, (n2 // d) * n1)


def shard_domain(values: GF, mesh: Mesh) -> GF:
    """The rank's contiguous slice of a (C, N) array's domain."""
    blk = values.shape[1] // mesh.size
    return values[:, mesh.rank * blk:(mesh.rank + 1) * blk]
