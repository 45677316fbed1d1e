"""Narrow-queue sponge region: the in-circuit counterpart of QueueSimulator.

Counterpart of the JAX package's `circuits/narrow_region.py`. A narrow queue
push hashes [enc(20) || old_tail(4)] = 24 values from a FRESH zero state in 3
rate-8 chunks; the new 4-element tail is the final state's first lanes
(circuit_encodings/src/lib.rs:179-221, the log-query queue flavor every
sorter/demux circuit consumes).

Layout (the RAM circuit's tile scheme, circuits/ram_permutation_circuit.py):
a region is `tiles` vertical TILES of 16 columns (12 state lanes +
block-validity bv + 3 gated selectors); one ELEMENT = 3 consecutive
Poseidon2 blocks (96 rows) in one tile. Powers of two are not divisible by
96, so each tile hosts floor(n/96) elements and the remaining rows are dead
(no copy wiring, transitions gated off by bv).

Tail tracking is DENSE, not in the lanes: the running tail lives in 4
register columns of the circuit's dense region (TIN), advanced by a
mux gate `TIN' = A'*TOUT + (1-A')*TIN`, with TIN/TOUT copy-wired to the
element's chunk-3 input lanes 4..7 / output lanes 0..3. Inactive (bv=0)
elements therefore need NO carry constraints at all — their rows are free
witness — which is what lets an output/demux queue absorb an arbitrary
SUBSET of element slots (non-monotone bv) while the tail register skips the
inactive ones.

Per-tile constraints (emitted by `narrow_region_gates`):
  - gated-selector defs g_* = s_* * bv; bv boolean; bv constant within a
    block (ssum) and across an element's 3 chunks (s_chunk_end);
  - Poseidon2 transitions per lane, active only when bv = 1;
  - chunk boundary: capacity lanes carry when bv = 1 (rate lanes are
    overwritten by the next chunk's copy-wired encoding);
  - element boundary (s_elem_end, incl. the cyclic row n-1 -> 0 wrap): a
    VALID next element starts from zero capacity lanes (fresh sponge).

The port's differences, none in what is computed: the device algebra
evaluates all tiles of a region at once (`DeviceAlgebra.stacks_tiles`); the
copy wiring comes as arrays of cell pairs; the witness is built on the
device, the rows of every active element's three chunks by
`_block_rows_device` in three batched calls, with the serial tail chain in
between (one Poseidon2 permutation per active element).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..ops.poseidon2_params import T, get_params
from . import poseidon2_circuit as p2c
from .poseidon2_circuit import ROWS_PER_PERMUTATION
from .ram_permutation_circuit import _block_rows_device, stacked, unstack

P = gl.P
CHUNKS = 3
ROWS_PER_ELEMENT = CHUNKS * ROWS_PER_PERMUTATION  # 96
TILE_WIDTH = 16  # 12 state + bv + g_lin + g_ext + g_int
ENC_WIDTH = 20   # log-query packed width


@dataclasses.dataclass(frozen=True)
class NarrowGeometry:
    log_n: int
    tiles: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def elements_per_tile(self) -> int:
        return (self.n // ROWS_PER_PERMUTATION) // CHUNKS

    @property
    def capacity(self) -> int:
        """Element slots per region."""
        return self.tiles * self.elements_per_tile

    @property
    def region_width(self) -> int:
        return TILE_WIDTH * self.tiles

    def slot_position(self, s: int) -> Tuple[int, int]:
        """(tile, first row) of element slot s."""
        t, l = divmod(s, self.elements_per_tile)
        return t, ROWS_PER_ELEMENT * l


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


NUM_GATES_PER_TILE = 26


def _tile_gates(alg, state, nxt, bv, bv_next, g, rc, sel, diag, ssum):
    """The NUM_GATES_PER_TILE constraints of one tile. `ssum` is s_lin +
    s_ext + s_int, formed once for the region (the in-circuit verifier
    replays these algebra calls, so their number and order are the JAX
    package's)."""
    s_lin, s_ext, s_int, s_ce, s_ee = sel
    g_lin, g_ext, g_int = g
    out = []
    out.append(alg.sub(g_lin, alg.mul(s_lin, bv)))
    out.append(alg.sub(g_ext, alg.mul(s_ext, bv)))
    out.append(alg.sub(g_int, alg.mul(s_int, bv)))
    out.append(alg.sub(alg.mul(bv, bv), bv))
    out.append(alg.mul(ssum, alg.sub(bv_next, bv)))
    out.append(alg.mul(s_ce, alg.sub(bv_next, bv)))
    lin_out = p2c._external_linear_alg(alg, state)
    sboxed = [p2c._pow7_alg(alg, alg.add(state[i], rc[i])) for i in range(T)]
    ext_out = p2c._external_linear_alg(alg, sboxed)
    s_prime = list(state)
    s_prime[0] = sboxed[0]
    int_out = p2c._internal_linear_alg(alg, s_prime, diag)
    for i in range(T):
        t1 = alg.mul(g_lin, alg.sub(nxt[i], lin_out[i]))
        t2 = alg.mul(g_ext, alg.sub(nxt[i], ext_out[i]))
        t3 = alg.mul(g_int, alg.sub(nxt[i], int_out[i]))
        out.append(alg.add(alg.add(t1, t2), t3))
    # chunk boundary: capacity lanes carry within a valid element
    for i in range(8, T):
        out.append(alg.mul(alg.mul(s_ce, bv), alg.sub(nxt[i], state[i])))
    # element boundary (and cyclic wrap): valid elements start fresh
    for i in range(8, T):
        out.append(alg.mul(alg.mul(s_ee, bv_next), nxt[i]))
    return out


def narrow_region_gates(alg, w, w_next, c, base: int, geo: NarrowGeometry,
                        rc_idx: int, slin: int, sext: int, sint: int,
                        chunk_end: int, elem_end: int) -> List:
    """Gate constraints for one narrow region at column offset `base`.

    Emits geo.tiles * NUM_GATES_PER_TILE constraints, tile by tile; the
    device algebra computes them for all tiles at once."""
    diag = get_params()["internal_diag"]
    rc = [c[rc_idx + i] for i in range(T)]
    sel = (c[slin], c[sext], c[sint], c[chunk_end], c[elem_end])
    ssum = alg.add(alg.add(sel[0], sel[1]), sel[2])

    def tile_gates(lane):
        return _tile_gates(alg, [lane(w, i) for i in range(T)],
                           [lane(w_next, i) for i in range(T)],
                           lane(w, 12), lane(w_next, 12),
                           [lane(w, 13 + k) for k in range(3)], rc, sel, diag,
                           ssum)

    if getattr(alg, "stacks_tiles", False):
        return unstack(tile_gates(lambda cols, i: stacked(
            [cols[base + TILE_WIDTH * t + i] for t in range(geo.tiles)])))
    out = []
    for t in range(geo.tiles):
        b = base + TILE_WIDTH * t
        out += tile_gates(lambda cols, i, b=b: cols[b + i])
    return out


def narrow_cadence_const(geo: NarrowGeometry) -> np.ndarray:
    """(n, 2) uint64 columns [s_chunk_end, s_elem_end] for the 96-row
    element cadence (shared by every region in the circuit)."""
    n = geo.n
    rows = np.zeros((n, 2), dtype=np.uint64)
    live = ROWS_PER_ELEMENT * geo.elements_per_tile
    r = np.arange(ROWS_PER_PERMUTATION - 1, live, ROWS_PER_PERMUTATION)
    elem_end = r % ROWS_PER_ELEMENT == ROWS_PER_ELEMENT - 1
    rows[r[~elem_end], 0] = 1
    rows[r[elem_end], 1] = 1
    rows[n - 1, 1] = 1  # cyclic wrap: row 0 of every tile starts fresh
    return rows


Cell = Callable[..., Tuple[np.ndarray, np.ndarray]]


def narrow_region_copy_cycles(base: int, geo: NarrowGeometry, slots: int,
                              enc_cell: Cell, bv_cell: Cell, tin_cell: Cell,
                              tout_cell: Cell
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Static wiring: slot s's rate lanes <- enc_cell(s, j) (j in 0..20),
    chunk-3 lanes 4..7 <- tin_cell(s, k), output lanes 0..3 -> tout_cell,
    bv <- bv_cell(s).

    The cycles are pairs; they come as two (m, 2) arrays of (col, row), in
    the JAX package's order (slot by slot: the first two chunks' 8 lanes
    pair by pair, then per k the chunk-3 encoding lane, tail-in lane and
    output lane, then bv). The cell functions take an array of slots."""
    assert slots <= geo.capacity
    s = np.arange(slots, dtype=np.int64)
    t, l = np.divmod(s, geo.elements_per_tile)
    tb = base + TILE_WIDTH * t
    r0 = ROWS_PER_ELEMENT * l
    links = []  # (tile cell col, tile cell row, other (col, row))
    for j in range(8):
        links.append((tb + j, r0, enc_cell(s, j)))
        links.append((tb + j, r0 + ROWS_PER_PERMUTATION, enc_cell(s, 8 + j)))
    for k in range(4):
        links.append((tb + k, r0 + 2 * ROWS_PER_PERMUTATION,
                      enc_cell(s, 16 + k)))
        links.append((tb + 4 + k, r0 + 2 * ROWS_PER_PERMUTATION,
                      tin_cell(s, k)))
        links.append((tb + k, r0 + ROWS_PER_ELEMENT - 1, tout_cell(s, k)))
    links.append((tb + 12, r0, bv_cell(s)))

    def grid(parts):
        return np.stack([np.broadcast_to(np.asarray(p, dtype=np.int64),
                                         (slots,)) for p in parts], axis=1)

    a = np.stack([grid([x[0] for x in links]), grid([x[1] for x in links])],
                 axis=-1).reshape(-1, 2)
    b = np.stack([grid([x[2][0] for x in links]),
                  grid([x[2][1] for x in links])], axis=-1).reshape(-1, 2)
    return a, b


def narrow_region_witness(geo: NarrowGeometry, enc: np.ndarray,
                          active: Sequence[int], head: Sequence[int],
                          block_const: np.ndarray, device=None
                          ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Sponge witness for one region.

    enc: (slots, 20) uint64 encodings staged per slot (only active slots'
    values are hashed); active: (slots,) 0/1; head: 4-element initial tail.
    block_const: _block_const_rows() (for the gated-selector columns).

    Returns (cols (16*tiles, n) on `device`, tin (slots+1, 4), tout (slots,
    4) as uint64): tin[s] = tail before slot s, tout[s] = slot s's emitted
    tail value (= tin[s] for inactive slots so the mux gate holds
    trivially).
    """
    device = gl.resolve_device(device)
    n = geo.n
    enc = np.asarray(enc, dtype=np.uint64).reshape(-1, ENC_WIDTH)
    slots = enc.shape[0]
    assert slots <= geo.capacity
    act = np.asarray(active, dtype=np.int64).reshape(-1) != 0
    idx = np.flatnonzero(act)
    B = len(idx)
    tail = gl.from_int(np.array([int(v) % P for v in head], dtype=object),
                       device)
    E = gl.from_u64(enc, device)
    blocks = None
    tails = [tail]
    if B:
        ea = E[torch.from_numpy(idx).to(device)]  # (B, 20)
        zeros4 = torch.zeros((B, 4), dtype=torch.int64, device=device)
        # chunks 1-2 do not depend on the tail: batched
        rows1 = _block_rows_device(torch.cat([ea[:, 0:8], zeros4], dim=1))
        rows2 = _block_rows_device(torch.cat([ea[:, 8:16], rows1[:, -1, 8:]],
                                             dim=1))
        # chunk 3 consumes the running tail: a serial chain of one
        # permutation per active element, then all of its rows batched
        caps2 = rows2[:, -1, 8:]
        for i in range(B):
            tail = p2.permute(torch.cat([ea[i, 16:20], tail, caps2[i]]))[:4]
            tails.append(tail)
        tails_t = torch.stack(tails)  # (B + 1, 4)
        rows3 = _block_rows_device(torch.cat([ea[:, 16:20], tails_t[:-1],
                                              caps2], dim=1))
        if not torch.equal(rows3[:, -1, :4], tails_t[1:]):
            raise AssertionError("chunk-3 rows diverged from the tail chain")
        blocks = torch.cat([rows1, rows2, rows3], dim=1)  # (B, 96, 12)
        del rows1, rows2, rows3
    tails_np = gl.to_u64(torch.stack(tails))  # (B + 1, 4)
    before = np.cumsum(act) - act  # active slots before slot s
    tin = np.empty((slots + 1, 4), dtype=np.uint64)
    tin[:slots] = tails_np[before]
    tin[slots] = tails_np[B]
    tout = tails_np[before + act]

    # slot blocks (capacity, 96, 16) in row order, then into the tiles
    sb = torch.zeros((geo.capacity, ROWS_PER_ELEMENT, TILE_WIDTH),
                     dtype=torch.int64, device=device)
    if B:
        it = torch.from_numpy(idx).to(device)
        sb[it, :, :T] = blocks
        sb[it, :, T] = 1
        sel = np.tile(np.asarray(block_const[:, T:T + 3], dtype=object)
                      .astype(np.int64), (CHUNKS, 1))  # (96, 3)
        sb[it, :, T + 1:] = torch.from_numpy(sel).to(device)
    # inactive slots: free rows, only the copy-wired cells (staged
    # encoding lanes, chunk-3 tail-in lanes, output lanes)
    ina = np.flatnonzero(~act)
    if len(ina):
        ii = torch.from_numpy(ina).to(device)
        e = E[ii]
        sb[ii, 0, 0:8] = e[:, 0:8]
        sb[ii, ROWS_PER_PERMUTATION, 0:8] = e[:, 8:16]
        sb[ii, 2 * ROWS_PER_PERMUTATION, 0:4] = e[:, 16:20]
        sb[ii, 2 * ROWS_PER_PERMUTATION, 4:8] = gl.from_u64(tin[ina], device)
        sb[ii, ROWS_PER_ELEMENT - 1, 0:4] = gl.from_u64(tout[ina], device)
    live = ROWS_PER_ELEMENT * geo.elements_per_tile
    cols = torch.zeros((geo.tiles, TILE_WIDTH, n), dtype=torch.int64,
                       device=device)
    cols[:, :, :live] = sb.reshape(geo.tiles, live, TILE_WIDTH).transpose(1, 2)
    return cols.reshape(geo.region_width, n), tin, tout
