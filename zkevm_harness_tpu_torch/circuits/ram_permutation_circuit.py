"""RAM permutation circuit: the first REAL base-layer gate set (type 8).

Counterpart of the JAX package's `circuits/ram_permutation_circuit.py`.
Proves, for one instance of the RAM permutation argument (reference:
circuit_definitions base_layer ram_permutation + the witness decomposer
src/witness/individual_circuits/ram_permutation.rs:26-120):

  1. absorbing this instance's segment of the UNSORTED memory queue into the
     full-width Poseidon2 sponge chain takes the segment head state to the
     segment tail state (same for the SORTED queue);
  2. the two grand products  prod(gamma + sum_j ch_j * enc_j)  over the
     valid items agree side-by-side (two independent challenge repetitions),
     proving the sorted queue is a permutation of the unsorted one;
  3. the sorted stream is genuinely sorted by (page, index, timestamp) and
     RAM-consistent: same cell => strictly increasing timestamps and reads
     return the previous value; new cell => reads return 0
     (byte-decomposition range checks via logup lookups);
  4. FSM continuation: queue states, accumulator values, item count, and the
     previous instance's last sorted entry are public inputs, so a chain of
     instances covers an unbounded memory trace.

Layout: the sponge region is K vertical TILES of 16 columns each (12 state
lanes + block-validity bv + 3 gated selectors), each tile hosting n/32
Poseidon2 blocks of the 32-row cadence from poseidon2_circuit. The two
queues occupy K/2 tiles each, chained block-to-block by boundary constraints
(cyclic next-row rotation links row n-1 of tile t to row 0 of tile t+1, so
NO dynamic wiring is needed) — capacity = (K/2) * (n/32) queries per
instance.

Partial instances: bv gates every sponge transition (a materialized
selector*validity product keeps gate degree at 8); invalid blocks CARRY the
state unchanged, so the final tail PI is correct for any item count. The
dense region's per-row validity v is copy-wired to bv and gates the grand
product and sort constraints.

Dense region (one row per query, rows 1..cap): challenge columns (held
constant by gates, bound by PIs), both encodings (copy-wired to the sponge
absorption rows), 4 accumulator chains, validity/count, and the sort-check
columns (index/rw/ptr decomposition, page/index equality flags with
provided inverses, and a shared 4-byte range check of the lexicographic
"deciding difference" minus one).

Sortedness is checked LEXICOGRAPHICALLY on 32-bit limbs (page, index,
timestamp): the deciding difference must satisfy D - 1 in [0, 2^32) via byte
lookups; every limb is < 2^32 << p, so the 4-byte decomposition is injective
mod p.

The port's differences, none in what is computed: the tile constraints are
one function (`_tile_gates`) that the device algebra evaluates over all
tiles at once (`DeviceAlgebra.stacks_tiles`); the copy wiring is built as
arrays of cell pairs (`_copy_pairs`, a `CopyWiring` for the setup); the
witness is built as int64 columns on the device, its sponge rows by
`_block_rows_device` over the valid blocks only (an invalid block carries
its input), its dense region in numpy with per-query Python only over the
valid queries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import R_F, R_P, T, const_tables_u64, get_params
from ..prover import plonkish as pk
from ..witness.queues import simulate_states_full
from . import poseidon2_circuit as p2c
from .poseidon2_circuit import ROWS_PER_PERMUTATION

P = gl.P
TILE_WIDTH = 16          # 12 state + bv + g_lin + g_ext + g_int
DENSE_WIDTH = 55         # dense-region columns (see _DenseCols)
NUM_CHALLENGES = 18      # 2 repetitions x (8 per-lane + gamma)


@dataclasses.dataclass(frozen=True)
class RamGeometry:
    log_n: int
    tiles_per_queue: int  # K/2

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def blocks_per_tile(self) -> int:
        return self.n // ROWS_PER_PERMUTATION

    @property
    def capacity(self) -> int:
        """Queries per instance (cycles_per_ram_permutation analogue)."""
        return self.tiles_per_queue * self.blocks_per_tile

    @property
    def num_tiles(self) -> int:
        return 2 * self.tiles_per_queue

    @property
    def dense_base(self) -> int:
        return TILE_WIDTH * self.num_tiles

    @property
    def num_witness(self) -> int:
        return self.dense_base + DENSE_WIDTH


class _DenseCols:
    """Offsets inside the dense region."""
    CH = 0          # 18 challenge columns (2 reps x 9)
    U_ENC = 18      # 8 unsorted encoding lanes
    S_ENC = 26      # 8 sorted encoding lanes
    ACC = 34        # acc_l1, acc_r1, acc_l2, acc_r2
    V = 38
    CNT = 39
    INDEX = 40
    RW = 41
    PTR = 42
    IB = 43         # 4 index bytes
    E_P = 47        # page-equality flag (row i+1 describes step i -> i+1)
    E_I = 48        # index-equality flag
    INV_P = 49      # provided inverse of page diff (when unequal)
    INV_I = 50      # provided inverse of index diff
    DB = 51         # 4 bytes of the deciding lexicographic diff minus 1


# const columns: 12 poseidon rc + s_lin + s_ext + s_int + s_d + s_q + s_end
# + s_wrap
C_RC = 0
C_SLIN, C_SEXT, C_SINT = T, T + 1, T + 2
C_SD, C_SQ, C_SEND, C_SWRAP = T + 3, T + 4, T + 5, T + 6
NUM_CONST = T + 7


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


def stacked(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """One lane of several tiles as one (tiles, n) tensor."""
    return torch.stack(list(values))


def unstack(per_kind: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Constraint values of stacked tiles, (tiles, n) per kind, back into
    the tile-by-tile order [tile 0's kinds, tile 1's kinds, ...]."""
    return [v[t] for t in range(per_kind[0].shape[0]) for v in per_kind]


def _tile_gates(alg, state, nxt, bv, bv_next, g, rc, sel, diag, ssum):
    """The 29 constraints of one sponge tile: gated-selector definitions, bv
    boolean and constant within a block, the Poseidon2 transitions (carried
    when bv = 0), and the block boundary inside the tile. `ssum` is
    s_lin + s_ext + s_int, formed once for all tiles (the in-circuit
    verifier replays these algebra calls, so their number and order are the
    JAX package's)."""
    s_lin, s_ext, s_int, s_end = sel
    g_lin, g_ext, g_int = g
    out = []
    # gated-selector definitions (degree 2)
    out.append(alg.sub(g_lin, alg.mul(s_lin, bv)))
    out.append(alg.sub(g_ext, alg.mul(s_ext, bv)))
    out.append(alg.sub(g_int, alg.mul(s_int, bv)))
    # bv boolean + constant within a block (rows 0..30)
    out.append(alg.sub(alg.mul(bv, bv), bv))
    out.append(alg.mul(ssum, alg.sub(bv_next, bv)))
    # permutation transitions, carried when bv = 0
    lin_out = p2c._external_linear_alg(alg, state)
    sboxed = [p2c._pow7_alg(alg, alg.add(state[i], rc[i])) for i in range(T)]
    ext_out = p2c._external_linear_alg(alg, sboxed)
    s_prime = list(state)
    s_prime[0] = sboxed[0]
    int_out = p2c._internal_linear_alg(alg, s_prime, diag)
    carry_sel = alg.mul(ssum, _one_minus(alg, bv))
    for i in range(T):
        t1 = alg.mul(g_lin, alg.sub(nxt[i], lin_out[i]))
        t2 = alg.mul(g_ext, alg.sub(nxt[i], ext_out[i]))
        t3 = alg.mul(g_int, alg.sub(nxt[i], int_out[i]))
        t4 = alg.mul(carry_sel, alg.sub(nxt[i], state[i]))
        out.append(alg.add(alg.add(t1, t2), alg.add(t3, t4)))
    # block boundary inside the tile (row 31 -> 32, except row n-1):
    # capacity lanes always carry; rate lanes carry when next block
    # is invalid (valid blocks overwrite them with the encoding)
    for i in range(8, T):
        out.append(alg.mul(s_end, alg.sub(nxt[i], state[i])))
    inval_next = alg.mul(s_end, _one_minus(alg, bv_next))
    for i in range(8):
        out.append(alg.mul(inval_next, alg.sub(nxt[i], state[i])))
    return out


def _wrap_gates(alg, cur, suc, bv_succ, s_wrap):
    """The 12 cross-tile chaining constraints of one tile pair at row n-1
    (`cur`: the tile's lanes, `suc`: the next tile's lanes at the next row)."""
    out = []
    for i in range(8, T):
        out.append(alg.mul(s_wrap, alg.sub(suc[i], cur[i])))
    iv = alg.mul(s_wrap, _one_minus(alg, bv_succ))
    for i in range(8):
        out.append(alg.mul(iv, alg.sub(suc[i], cur[i])))
    return out


def ram_ir(log_n: int, tiles_per_queue: int = 1) -> pk.PlonkishIR:
    geo = RamGeometry(log_n, tiles_per_queue)
    n = geo.n
    cap = geo.capacity
    assert cap + 1 <= n, "dense region must fit the trace"
    params = get_params()
    diag = params["internal_diag"]
    D = geo.dense_base
    K = geo.tiles_per_queue

    def eval_gates(alg, w, w_next, c):
        out = []
        rc = c[:T]
        sel = (c[C_SLIN], c[C_SEXT], c[C_SINT], c[C_SEND])
        s_d, s_q, s_wrap = c[C_SD], c[C_SQ], c[C_SWRAP]
        batched = getattr(alg, "stacks_tiles", False)

        # ---- sponge tiles -------------------------------------------------
        def lanes(cols, tiles, i):
            if batched:
                return stacked([cols[TILE_WIDTH * t + i] for t in tiles])
            return cols[TILE_WIDTH * tiles[0] + i]

        ssum = alg.add(alg.add(sel[0], sel[1]), sel[2])

        def tile_gates(tiles):
            return _tile_gates(
                alg, [lanes(w, tiles, i) for i in range(T)],
                [lanes(w_next, tiles, i) for i in range(T)],
                lanes(w, tiles, 12), lanes(w_next, tiles, 12),
                [lanes(w, tiles, 13 + k) for k in range(3)], rc, sel, diag,
                ssum)

        if batched:
            out += unstack(tile_gates(list(range(geo.num_tiles))))
        else:
            for t in range(geo.num_tiles):
                out += tile_gates([t])

        # cross-tile chaining at row n-1 (cyclic rotation: next = row 0 of
        # the NEXT tile's columns)
        for q in range(2):
            tiles = list(range(q * K, (q + 1) * K - 1))
            if not tiles:
                continue
            succ = [t + 1 for t in tiles]
            if batched:
                out += unstack(_wrap_gates(
                    alg, [lanes(w, tiles, i) for i in range(T)],
                    [lanes(w_next, succ, i) for i in range(T)],
                    lanes(w_next, succ, 12), s_wrap))
            else:
                for t in tiles:
                    out += _wrap_gates(
                        alg, [w[TILE_WIDTH * t + i] for i in range(T)],
                        [w_next[TILE_WIDTH * (t + 1) + i] for i in range(T)],
                        w_next[TILE_WIDTH * (t + 1) + 12], s_wrap)

        # ---- dense region -------------------------------------------------
        ch = [w[D + _DenseCols.CH + j] for j in range(NUM_CHALLENGES)]
        ch_next = [w_next[D + _DenseCols.CH + j] for j in range(NUM_CHALLENGES)]
        u_next = [w_next[D + _DenseCols.U_ENC + j] for j in range(8)]
        s_cur = [w[D + _DenseCols.S_ENC + j] for j in range(8)]
        s_next = [w_next[D + _DenseCols.S_ENC + j] for j in range(8)]
        v = w[D + _DenseCols.V]
        v_next = w_next[D + _DenseCols.V]
        cnt = w[D + _DenseCols.CNT]
        cnt_next = w_next[D + _DenseCols.CNT]

        # challenges constant down the dense rows
        for j in range(NUM_CHALLENGES):
            out.append(alg.mul(s_d, alg.sub(ch_next[j], ch[j])))
        # validity boolean + prefix monotone; count accumulator
        out.append(alg.mul(s_d, alg.sub(alg.mul(v_next, v_next), v_next)))
        out.append(alg.mul(s_d, alg.mul(v_next, _one_minus(alg, v))))
        out.append(alg.mul(s_d, alg.sub(cnt_next, alg.add(cnt, v_next))))

        # grand-product accumulators: acc' = acc * (v'*Tterm + 1 - v')
        def acc_gate(acc_off, enc_vals, rep):
            base = rep * 9
            term = ch[base + 8]
            for j in range(8):
                term = alg.add(term, alg.mul(ch[base + j], enc_vals[j]))
            gated = alg.add(alg.mul(v_next, term), _one_minus(alg, v_next))
            acc = w[D + _DenseCols.ACC + acc_off]
            acc_next = w_next[D + _DenseCols.ACC + acc_off]
            return alg.mul(s_d, alg.sub(acc_next, alg.mul(acc, gated)))

        out.append(acc_gate(0, u_next, 0))
        out.append(acc_gate(1, s_next, 0))
        out.append(acc_gate(2, u_next, 1))
        out.append(acc_gate(3, s_next, 1))

        # sorted-stream decomposition (rows 1..cap, gated by validity)
        index = w[D + _DenseCols.INDEX]
        index_next = w_next[D + _DenseCols.INDEX]
        rw = w[D + _DenseCols.RW]
        ptr = w[D + _DenseCols.PTR]
        rw_next = w_next[D + _DenseCols.RW]
        ib = [w[D + _DenseCols.IB + k] for k in range(4)]
        sqv = alg.mul(s_q, v)
        flags = alg.add(index, alg.add(alg.mul_int(rw, 1 << 32),
                                       alg.mul_int(ptr, 1 << 33)))
        out.append(alg.mul(sqv, alg.sub(s_cur[2], flags)))
        out.append(alg.mul(s_q, alg.sub(alg.mul(rw, rw), rw)))
        out.append(alg.mul(s_q, alg.sub(alg.mul(ptr, ptr), ptr)))
        ib_sum = ib[0]
        for k in range(1, 4):
            ib_sum = alg.add(ib_sum, alg.mul_int(ib[k], 1 << (8 * k)))
        out.append(alg.mul(sqv, alg.sub(index, ib_sum)))

        # adjacency: rows i -> i+1 over the sorted stream, lexicographic on
        # 32-bit limbs (page = lane 1, index, timestamp = lane 0)
        e_p = w_next[D + _DenseCols.E_P]
        e_i = w_next[D + _DenseCols.E_I]
        inv_p = w_next[D + _DenseCols.INV_P]
        inv_i = w_next[D + _DenseCols.INV_I]
        db_next = [w_next[D + _DenseCols.DB + k] for k in range(4)]
        sdv = alg.mul(s_d, v_next)
        pd = alg.sub(s_next[1], s_cur[1])
        di = alg.sub(index_next, index)
        dt = alg.sub(s_next[0], s_cur[0])
        # equality flags: boolean; e=1 => diff 0; e=0 => diff invertible
        out.append(alg.mul(s_d, alg.sub(alg.mul(e_p, e_p), e_p)))
        out.append(alg.mul(s_d, alg.sub(alg.mul(e_i, e_i), e_i)))
        out.append(alg.mul(sdv, alg.mul(e_p, pd)))
        out.append(alg.mul(sdv, alg.mul(_one_minus(alg, e_p),
                                        _one_minus(alg, alg.mul(pd, inv_p)))))
        out.append(alg.mul(sdv, alg.mul(alg.mul(e_p, e_i), di)))
        out.append(alg.mul(sdv, alg.mul(
            alg.mul(e_p, _one_minus(alg, e_i)),
            _one_minus(alg, alg.mul(di, inv_i)))))
        # deciding diff D >= 1 via D - 1 = 4 bytes (each limb < 2^32 << p, so
        # the decomposition is injective mod p and D cannot be negative)
        db_sum = db_next[0]
        for k in range(1, 4):
            db_sum = alg.add(db_sum, alg.mul_int(db_next[k], 1 << (8 * k)))
        d_val = alg.add(
            alg.mul(_one_minus(alg, e_p), pd),
            alg.add(alg.mul(alg.mul(e_p, _one_minus(alg, e_i)), di),
                    alg.mul(alg.mul(e_p, e_i), dt)))
        out.append(alg.mul(sdv, alg.sub(d_val, alg.add_int(db_sum, 1))))
        # same cell + read => value unchanged (lanes 3..7 hold all value bits)
        read_next = _one_minus(alg, rw_next)
        same = alg.mul(e_p, e_i)
        same_read = alg.mul(alg.mul(sdv, same), read_next)
        for j in range(3, 8):
            out.append(alg.mul(same_read, alg.sub(s_next[j], s_cur[j])))
        # new cell + read => value is zero (and not a pointer)
        new_read = alg.mul(alg.mul(sdv, _one_minus(alg, same)), read_next)
        for j in range(3, 8):
            out.append(alg.mul(new_read, s_next[j]))
        out.append(alg.mul(new_read, w_next[D + _DenseCols.PTR]))
        return out

    # per tile: 3 gated selectors + 2 bv + 12 lanes + 12 block boundary;
    # per cross-tile pair: 12; dense: 18 ch + 3 v/cnt + 4 acc + 4 decomp
    # + 7 lex-adjacency + 5 same-read + 6 new-read
    n_constraints = (geo.num_tiles * 29
                     + 2 * (geo.tiles_per_queue - 1) * 12
                     + NUM_CHALLENGES + 3 + 4 + 4 + 7 + 5 + 6)

    # public inputs (all FSM / closed-form-input bindings)
    pis: List[Tuple[int, int]] = []
    # challenges
    pis += [(D + _DenseCols.CH + j, 0) for j in range(NUM_CHALLENGES)]
    # unsorted queue: head capacity lanes + full tail
    u0 = 0
    uz = TILE_WIDTH * (geo.tiles_per_queue - 1)
    pis += [(u0 + i, 0) for i in range(8, T)]
    pis += [(uz + i, n - 1) for i in range(T)]
    # sorted queue
    s0 = TILE_WIDTH * geo.tiles_per_queue
    sz = TILE_WIDTH * (geo.num_tiles - 1)
    pis += [(s0 + i, 0) for i in range(8, T)]
    pis += [(sz + i, n - 1) for i in range(T)]
    # accumulators in/out, validity/count FSM
    pis += [(D + _DenseCols.ACC + k, 0) for k in range(4)]
    pis += [(D + _DenseCols.ACC + k, cap) for k in range(4)]
    pis += [(D + _DenseCols.V, 0), (D + _DenseCols.CNT, 0),
            (D + _DenseCols.CNT, cap)]
    # previous instance's last sorted entry (phantom zeros on instance 0)
    pis += [(D + _DenseCols.S_ENC + j, 0) for j in range(8)]
    pis += [(D + _DenseCols.INDEX, 0)]

    byte_table = np.arange(256, dtype=object).reshape(256, 1)
    lookup_cols = ([D + _DenseCols.IB + k for k in range(4)]
                   + [D + _DenseCols.DB + k for k in range(4)])
    lookup_sets = tuple((0, (c,)) for c in lookup_cols)

    return pk.PlonkishIR(
        log_n=log_n, num_witness=geo.num_witness, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(byte_table,), lookup_sets=lookup_sets)


def block_const_rows_u64() -> np.ndarray:
    """`poseidon2_circuit._block_const_rows()` as uint64, (32, T + 3)."""
    return p2c._block_const_rows().astype(np.uint64)


def _const_rows(geo: RamGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n = geo.n
    rows = np.zeros((n, NUM_CONST), dtype=np.uint64)
    rows[:, :T + 3] = np.tile(block_const_rows_u64(), (geo.blocks_per_tile, 1))
    cap = geo.capacity
    rows[0:cap, C_SD] = 1
    rows[1:cap + 1, C_SQ] = 1
    rows[ROWS_PER_PERMUTATION - 1:n - 1:ROWS_PER_PERMUTATION, C_SEND] = 1
    rows[n - 1, C_SWRAP] = 1
    return rows


def _copy_pairs(geo: RamGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """The setup's copy cycles as ordered cell pairs ((m, 2) arrays of
    (col, row)), in the order the JAX package lists them: per query q, the 8
    encoding lanes of both queues (dense row q+1 <-> the sponge absorption
    row of query q), then the validity triple (unsorted bv, sorted bv,
    dense v) as its two links."""
    D = geo.dense_base
    B = geo.blocks_per_tile
    q = np.arange(geo.capacity, dtype=np.int64)
    t, r = q // B, (q % B) * ROWS_PER_PERMUTATION
    ub = TILE_WIDTH * t
    sb = TILE_WIDTH * (geo.tiles_per_queue + t)
    a_col, a_row, b_col, b_row = [], [], [], []
    for j in range(8):
        for base, enc in ((ub, _DenseCols.U_ENC), (sb, _DenseCols.S_ENC)):
            a_col.append(base + j)
            a_row.append(r)
            b_col.append(np.full_like(q, D + enc + j))
            b_row.append(q + 1)
    a_col += [ub + 12, sb + 12]
    a_row += [r, r]
    b_col += [sb + 12, np.full_like(q, D + _DenseCols.V)]
    b_row += [r, q + 1]
    a = np.stack([np.stack(a_col, 1), np.stack(a_row, 1)], -1).reshape(-1, 2)
    b = np.stack([np.stack(b_col, 1), np.stack(b_row, 1)], -1).reshape(-1, 2)
    return a, b


def ram_setup(ir: pk.PlonkishIR, geo: RamGeometry,
              cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    wiring = pk.wire_copy_pairs(geo.n, *_copy_pairs(geo))
    return pk.build_setup(ir, _const_rows(geo).T, wiring, cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation (device-batched sponge row expansion)
# ---------------------------------------------------------------------------

def _m4(c):
    """Poseidon2's M4 on four lanes by its addition chain (rows
    [5,7,1,3], [4,6,1,1], [1,3,5,7], [1,1,4,6])."""
    c0, c1, c2, c3 = c
    add = gl.add
    t0 = add(c0, c1)
    t1 = add(c2, c3)
    t2 = add(add(c1, c1), t1)
    t3 = add(add(c3, c3), t0)
    t1x2 = add(t1, t1)
    t0x2 = add(t0, t0)
    t4 = add(add(t1x2, t1x2), t3)
    t5 = add(add(t0x2, t0x2), t2)
    return [add(t3, t5), t5, add(t2, t4), t4]


def _external_linear(x: gl.GF) -> gl.GF:
    """circ(2*M4, M4, M4) over the last axis (size 12), the three 4-lane
    chunks batched."""
    c = x.reshape(*x.shape[:-1], 3, 4)
    m = torch.stack(_m4([c[..., j] for j in range(4)]), dim=-1)
    total = gl.add(gl.add(m[..., 0, :], m[..., 1, :]), m[..., 2, :])
    return gl.add(m, total.unsqueeze(-2)).reshape(x.shape)


def _internal_linear(x: gl.GF, diag: gl.GF) -> gl.GF:
    """y_i = mu_i * x_i + sum_j x_j (all-ones + diag matrix)."""
    total = gl.sum_axis(x, axis=-1)
    return gl.add(gl.mul(x, diag), total.unsqueeze(-1))


def _block_rows_device(inputs: gl.GF) -> gl.GF:
    """(B, 12) block input states -> (B, 32, 12) full block row traces: the
    input, then the state after the initial linear layer and after each of
    the 30 rounds. Tensor code on the field kernels (add, mul, pow7), every
    round's state kept, over the whole batch of blocks at once."""
    ext_np, int_np, diag_np = const_tables_u64()
    dev = inputs.device
    ext = gl.from_u64(ext_np, dev)
    internal = gl.from_u64(int_np, dev)
    diag = gl.from_u64(diag_np, dev)
    half = R_F // 2
    rows = [inputs]
    s = _external_linear(inputs)
    rows.append(s)
    for r in range(half):
        s = _external_linear(gl.pow7(gl.add(s, ext[r])))
        rows.append(s)
    for r in range(R_P):
        lane0 = gl.pow7(gl.add(s[..., 0], internal[r]))
        s = _internal_linear(torch.cat([lane0.unsqueeze(-1), s[..., 1:]],
                                       dim=-1), diag)
        rows.append(s)
    for r in range(half):
        s = _external_linear(gl.pow7(gl.add(s, ext[half + r])))
        rows.append(s)
    return torch.stack(rows, dim=-2)


def _queue_tile_columns(geo: RamGeometry, encodings: np.ndarray,
                        head_state: Sequence[int], device) -> torch.Tensor:
    """Sponge witness for ONE queue as (tiles_per_queue, 13, n): per tile the
    12 state lanes and bv. encodings: (count, 8) uint64 with count <=
    capacity; invalid blocks carry the final state unchanged."""
    n = geo.n
    count = encodings.shape[0]
    head = gl.from_int(np.array(list(head_state), dtype=object), device)
    enc = gl.from_u64(encodings, device)
    if count:
        states = simulate_states_full(enc, head)  # (count + 1, 12)
        # valid block q absorbs [enc_q || capacity lanes of states[q]]
        inputs = torch.cat([enc, states[:count, 8:]], dim=1)
        valid = _block_rows_device(inputs)  # (count, 32, 12)
        if not torch.equal(valid[count - 1, -1], states[count]):
            raise AssertionError(
                "sponge row expansion diverged from queue simulator")
        final = states[count]
    else:
        valid = torch.zeros((0, ROWS_PER_PERMUTATION, T), dtype=torch.int64,
                            device=device)
        final = head
    carried = final.expand(geo.capacity - count, ROWS_PER_PERMUTATION, T)
    rows = torch.cat([valid, carried])  # (capacity, 32, 12)
    out = torch.zeros((geo.tiles_per_queue, T + 1, n), dtype=torch.int64,
                      device=device)
    out[:, :T] = rows.reshape(geo.tiles_per_queue, n, T).transpose(1, 2)
    bv = torch.zeros(geo.capacity, dtype=torch.int64, device=device)
    bv[:count] = 1
    out[:, T] = bv.repeat_interleave(ROWS_PER_PERMUTATION).reshape(
        geo.tiles_per_queue, n)
    return out


@dataclasses.dataclass
class RamInstanceInputs:
    """Everything one instance needs (the closed-form-input payload)."""
    unsorted_encodings: np.ndarray  # (count, 8)
    sorted_encodings: np.ndarray    # (count, 8)
    unsorted_head: Tuple[int, ...]  # 12-lane state
    sorted_head: Tuple[int, ...]
    challenges: Sequence[int]       # 18 values
    acc_in: Tuple[int, int, int, int]
    cnt_in: int
    prev_sorted_entry: Optional[Sequence[int]]  # 8-lane enc or None


def ram_witness(ir: pk.PlonkishIR, geo: RamGeometry,
                inst: RamInstanceInputs, device=None) -> gl.GF:
    """Assemble the full witness matrix (num_witness, n) for one instance on
    `device` (`None` means the CUDA card)."""
    device = gl.resolve_device(device)
    n = geo.n
    count = inst.unsorted_encodings.shape[0]
    assert inst.sorted_encodings.shape[0] == count <= geo.capacity
    D = geo.dense_base
    K = geo.tiles_per_queue
    u_enc = np.asarray(inst.unsorted_encodings,
                       dtype=object).astype(np.uint64).reshape(-1, 8)
    s_enc = np.asarray(inst.sorted_encodings,
                       dtype=object).astype(np.uint64).reshape(-1, 8)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)

    u_tiles = _queue_tile_columns(geo, u_enc, inst.unsorted_head, device)
    s_tiles = _queue_tile_columns(geo, s_enc, inst.sorted_head, device)
    # gated selectors g_* = s_* * bv
    sels = torch.from_numpy(_const_rows(geo)[:, C_SLIN:C_SINT + 1].T.astype(
        np.int64)).to(device)  # (3, n)
    for q, tiles in enumerate((u_tiles, s_tiles)):
        for t in range(K):
            base = TILE_WIDTH * (q * K + t)
            W[base:base + T + 1] = tiles[t]
            W[base + 13:base + 16] = sels * tiles[t, T]
    u_final = gl.to_u64(u_tiles[K - 1, :8, n - 1])
    s_final = gl.to_u64(s_tiles[K - 1, :8, n - 1])
    del u_tiles, s_tiles

    # dense region, rows 0..cap: exact ints for the valid queries
    cap = geo.capacity
    Wd = np.zeros((DENSE_WIDTH, cap + 1), dtype=np.uint64)
    C = _DenseCols
    ch = [int(v) % P for v in inst.challenges]
    assert len(ch) == NUM_CHALLENGES
    Wd[C.CH:C.CH + NUM_CHALLENGES, :] = np.array(ch, dtype=np.uint64)[:, None]
    prev = ([int(v) % P for v in inst.prev_sorted_entry]
            if inst.prev_sorted_entry is not None else [0] * 8)
    Wd[C.S_ENC:C.S_ENC + 8, 0] = prev
    Wd[C.V, 0] = 1
    Wd[C.CNT, 0] = inst.cnt_in
    acc = [int(a) % P for a in inst.acc_in]
    Wd[C.ACC:C.ACC + 4, 0] = acc

    def dec_index(enc2: int) -> Tuple[int, int, int]:
        return enc2 & 0xFFFFFFFF, (enc2 >> 32) & 1, (enc2 >> 33) & 1

    prev_index = dec_index(prev[2])[0] if inst.prev_sorted_entry else 0
    Wd[C.INDEX, 0] = prev_index
    prev_page, prev_ts = prev[1], prev[0]
    prev_vals = prev[3:8]

    for i in range(count):
        row = i + 1
        u = [int(v) for v in u_enc[i]]
        s = [int(v) for v in s_enc[i]]
        Wd[C.U_ENC:C.U_ENC + 8, row] = u
        Wd[C.S_ENC:C.S_ENC + 8, row] = s
        Wd[C.V, row] = 1
        for rep in range(2):
            tu = (ch[rep * 9 + 8] + sum(ch[rep * 9 + j] * u[j]
                                        for j in range(8))) % P
            ts_ = (ch[rep * 9 + 8] + sum(ch[rep * 9 + j] * s[j]
                                         for j in range(8))) % P
            acc[2 * rep] = acc[2 * rep] * tu % P
            acc[2 * rep + 1] = acc[2 * rep + 1] * ts_ % P
        Wd[C.ACC:C.ACC + 4, row] = acc
        index, rw, ptr = dec_index(s[2])
        Wd[C.INDEX, row] = index
        Wd[C.RW, row] = rw
        Wd[C.PTR, row] = ptr
        for k in range(4):
            Wd[C.IB + k, row] = (index >> (8 * k)) & 0xFF
        page = s[1]
        pd, di, dt = page - prev_page, index - prev_index, s[0] - prev_ts
        e_p = 1 if pd == 0 else 0
        e_i = 1 if di == 0 else 0
        Wd[C.E_P, row] = e_p
        Wd[C.E_I, row] = e_i
        if not e_p:
            Wd[C.INV_P, row] = pow(pd % P, P - 2, P)
        if not e_i:
            Wd[C.INV_I, row] = pow(di % P, P - 2, P)
        decide = pd if not e_p else (di if not e_i else dt)
        assert 1 <= decide < (1 << 32) + 1, "sorted stream out of order"
        for k in range(4):
            Wd[C.DB + k, row] = ((decide - 1) >> (8 * k)) & 0xFF
        if e_p and e_i:
            if rw == 0:
                assert s[3:8] == prev_vals, "read sees a stale value"
        elif rw == 0:
            assert s[3:8] == [0] * 5 and ptr == 0, \
                "read of a fresh cell must be 0"
        prev_page, prev_index = page, index
        prev_ts, prev_vals = s[0], s[3:8]
    # rows of invalid blocks: their encodings are the carried final states'
    # rate lanes; count and accumulators carry
    Wd[C.CNT, 1:] = inst.cnt_in + np.minimum(np.arange(1, cap + 1), count)
    pad = slice(count + 1, cap + 1)
    Wd[C.U_ENC:C.U_ENC + 8, pad] = u_final[:, None]
    Wd[C.S_ENC:C.S_ENC + 8, pad] = s_final[:, None]
    Wd[C.ACC:C.ACC + 4, pad] = np.array(acc, dtype=np.uint64)[:, None]
    W[D:D + DENSE_WIDTH, :cap + 1] = gl.from_u64(Wd, device)
    return W


def instance_inputs(inst_w, challenges: Sequence[int]) -> RamInstanceInputs:
    """Bridge a witness-side RamPermutationInstanceWitness (from
    witness/ram_permutation.compute_ram_circuit_snapshots) into the circuit's
    input payload."""
    return RamInstanceInputs(
        unsorted_encodings=np.asarray(inst_w.unsorted_encodings, dtype=object),
        sorted_encodings=np.asarray(inst_w.sorted_encodings, dtype=object),
        unsorted_head=tuple(inst_w.unsorted_queue_state[0]),
        sorted_head=tuple(inst_w.sorted_queue_state[0]),
        challenges=list(challenges),
        acc_in=tuple(inst_w.accumulators_in),
        cnt_in=int(inst_w.num_items_in),
        prev_sorted_entry=inst_w.prev_sorted_entry)


def instance_public_inputs(geo: RamGeometry, inst_w,
                           challenges: Sequence[int]) -> List[int]:
    """Expected PI vector straight from the decomposer's instance witness."""
    inst = instance_inputs(inst_w, challenges)
    return expected_public_inputs(
        geo, inst,
        u_tail=inst_w.unsorted_queue_state[1],
        s_tail=inst_w.sorted_queue_state[1],
        acc_out=inst_w.accumulators_out,
        cnt_out=inst_w.num_items_in + inst_w.num_items)


def expected_public_inputs(geo: RamGeometry, inst: RamInstanceInputs,
                           u_tail: Sequence[int], s_tail: Sequence[int],
                           acc_out: Sequence[int], cnt_out: int) -> List[int]:
    """The PI vector a verifier must see for this instance (order matches
    ram_ir's public_input_cells)."""
    prev = ([int(v) % P for v in inst.prev_sorted_entry]
            if inst.prev_sorted_entry is not None else [0] * 8)
    out = [int(v) % P for v in inst.challenges]
    out += [int(v) % P for v in list(inst.unsorted_head)[8:]]
    out += [int(v) % P for v in u_tail]
    out += [int(v) % P for v in list(inst.sorted_head)[8:]]
    out += [int(v) % P for v in s_tail]
    out += [int(v) % P for v in inst.acc_in]
    out += [int(v) % P for v in acc_out]
    out += [1, int(inst.cnt_in), int(cnt_out)]
    out += prev
    out += [prev[2] & 0xFFFFFFFF]
    return out
