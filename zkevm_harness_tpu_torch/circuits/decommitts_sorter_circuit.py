"""Code-decommittments sorter circuit: REAL base-layer gate set (type 2).

Proves, for one instance of the decommit-request sort+dedup argument
(reference: circuit_definitions base_layer code_decommitts_sorter + the
witness decomposer src/witness/individual_circuits/sort_decommit_requests.rs):

  1. absorbing this instance's segment of the UNSORTED decommit-request queue
     into the full-width Poseidon2 sponge chain takes the segment head state
     to the segment tail state (same for the SORTED queue and the emitted
     OUTPUT queue — decommit queues are full-width 8-limb flavors);
  2. two grand products (2 independent challenge repetitions over the 8-limb
     encodings) agree side-by-side: the sorted stream is a permutation of
     the input stream;
  3. the sorted stream strictly increases lexicographically in
     (code_hash, timestamp) — checked limb-wise with a one-hot
     first-difference selector and a 4-byte range check of the deciding
     difference minus one;
  4. dedup semantics: an element's is_fresh flag is 1 exactly when its hash
     differs from the previous sorted element's; repeated requests for the
     same hash must agree on the memory page; exactly the fresh elements are
     absorbed into the output queue — the feed for the code-decommitter
     circuit;
  5. FSM continuation: queue states, accumulators, item counts, and the
     previous instance's last sorted entry are public inputs.

Layout as the RAM permutation circuit's: three full-width sponge strips of
`tiles_per_queue` vertical tiles each (input, sorted, output), one Poseidon2
block of the 32-row cadence per element, plus a dense region with one row
per element. The output strip's bv is the EMIT flag (non-monotone across
blocks — invalid blocks carry the running state, so fresh elements can be
absorbed with gaps and the final tail is still exact).

Comparison-limb soundness: hash words h0..h2 and the timestamp are extracted
from packed limbs 0..2 with byte-lookup decompositions; limbs 3..7 are the
raw hash words h3..h7, bounded < 2^32 transitively through the permutation
argument and the scheduler's cross-check of the input queue.

Counterpart of the JAX package's `circuits/decommitts_sorter_circuit.py`.
The port's differences, none in what is computed: the tile constraints are
the RAM permutation circuit's `_tile_gates` / `_wrap_gates`, evaluated with
the tiles of a strip stacked on the device algebra; the copy cycles
(`_copy_cycles` there) are ordered cell pairs for `wire_copy_pairs`
(`_copy_pairs`); the witness is int64 columns on the device, the sponge
rows by `_block_rows_device` over the active blocks only (an inactive block
carries the running state), the dense region uint64 numpy with per-element
Python only over the valid elements.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import T, get_params
from ..prover import plonkish as pk
from ..witness.queues import simulate_states_full
from .poseidon2_circuit import ROWS_PER_PERMUTATION
from .ram_permutation_circuit import (_block_rows_device, _tile_gates,
                                      _wrap_gates, block_const_rows_u64,
                                      stacked, unstack)

P = gl.P
TILE_WIDTH = 16          # 12 state + bv + g_lin + g_ext + g_int
NUM_CHALLENGES = 18      # 2 repetitions x (8 per-lane + gamma)
NUM_CMP = 9              # comparison limbs: h7..h0 (BE), then timestamp


class _D:
    """Dense-region column offsets."""
    CH = 0
    U_ENC = 18
    S_ENC = 26
    O_ENC = 34
    ACC = 42       # lhs0, rhs0, lhs1, rhs1
    V = 46
    CNT = 47
    OCNT = 48
    EMIT = 49
    HB0 = 50       # 4 bytes of hash word h0 (limb 0 low 32)
    HB1 = 54       # 4 bytes of h1
    HB2 = 58       # 4 bytes of h2
    PB = 62        # 4 memory-page bytes
    TB = 66        # 4 timestamp bytes
    FB = 70        # is_fresh flag (bit 48 of limb 2)
    DSEL = 71      # 9 one-hot first-difference selectors
    DB = 80        # 4 bytes of deciding diff minus 1


DENSE_WIDTH = 84

# const columns: 12 poseidon rc + s_lin/s_ext/s_int + s_d + s_q + s_end + s_wrap
C_RC = 0
C_SLIN, C_SEXT, C_SINT = T, T + 1, T + 2
C_SD, C_SQ, C_SEND, C_SWRAP = T + 3, T + 4, T + 5, T + 6
NUM_CONST = T + 7


@dataclasses.dataclass(frozen=True)
class DecommittsGeometry:
    log_n: int
    tiles_per_queue: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def blocks_per_tile(self) -> int:
        return self.n // ROWS_PER_PERMUTATION

    @property
    def capacity(self) -> int:
        """Requests per instance (cycles_per_code_decommitter_sorter
        analogue, geometry_config.rs)."""
        return self.tiles_per_queue * self.blocks_per_tile

    @property
    def num_tiles(self) -> int:
        return 3 * self.tiles_per_queue

    @property
    def dense_base(self) -> int:
        return TILE_WIDTH * self.num_tiles

    @property
    def num_witness(self) -> int:
        return self.dense_base + DENSE_WIDTH


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


def _strip_gates(alg, w, w_next, c, geo: DecommittsGeometry, strip: int,
                 diag) -> List:
    """Sponge constraints for one queue strip (tiles_per_queue tiles), then
    its cross-tile chaining at row n-1."""
    rc = c[:T]
    sel = (c[C_SLIN], c[C_SEXT], c[C_SINT], c[C_SEND])
    s_wrap = c[C_SWRAP]
    batched = getattr(alg, "stacks_tiles", False)
    first = strip * geo.tiles_per_queue
    tiles = list(range(first, first + geo.tiles_per_queue))

    def lanes(cols, ts, i):
        if batched:
            return stacked([cols[TILE_WIDTH * t + i] for t in ts])
        return cols[TILE_WIDTH * ts[0] + i]

    ssum = alg.add(alg.add(sel[0], sel[1]), sel[2])  # once per strip

    def tile_gates(ts):
        return _tile_gates(
            alg, [lanes(w, ts, i) for i in range(T)],
            [lanes(w_next, ts, i) for i in range(T)],
            lanes(w, ts, 12), lanes(w_next, ts, 12),
            [lanes(w, ts, 13 + k) for k in range(3)], rc, sel, diag, ssum)

    out = []
    if batched:
        out += unstack(tile_gates(tiles))
    else:
        for t in tiles:
            out += tile_gates([t])
    cur, succ = tiles[:-1], tiles[1:]
    if not cur:
        return out
    if batched:
        out += unstack(_wrap_gates(
            alg, [lanes(w, cur, i) for i in range(T)],
            [lanes(w_next, succ, i) for i in range(T)],
            lanes(w_next, succ, 12), s_wrap))
    else:
        for t in cur:
            out += _wrap_gates(
                alg, [w[TILE_WIDTH * t + i] for i in range(T)],
                [w_next[TILE_WIDTH * (t + 1) + i] for i in range(T)],
                w_next[TILE_WIDTH * (t + 1) + 12], s_wrap)
    return out


GATES_PER_TILE = 29
GATES_PER_CHAIN_LINK = 12


def decommitts_ir(log_n: int, tiles_per_queue: int = 1) -> pk.PlonkishIR:
    geo = DecommittsGeometry(log_n, tiles_per_queue)
    n, cap = geo.n, geo.capacity
    assert cap + 1 <= n, "dense region must fit the trace"
    assert n >= 256, "byte lookup table needs 256 rows"
    diag = get_params()["internal_diag"]
    D = geo.dense_base

    def eval_gates(alg, w, w_next, c):
        out = []
        for strip in range(3):
            out += _strip_gates(alg, w, w_next, c, geo, strip, diag)

        s_d, s_q = c[C_SD], c[C_SQ]
        ch = [w[D + _D.CH + j] for j in range(NUM_CHALLENGES)]
        ch_next = [w_next[D + _D.CH + j] for j in range(NUM_CHALLENGES)]
        u_next = [w_next[D + _D.U_ENC + j] for j in range(8)]
        s_cur = [w[D + _D.S_ENC + j] for j in range(8)]
        s_next = [w_next[D + _D.S_ENC + j] for j in range(8)]
        o_next = [w_next[D + _D.O_ENC + j] for j in range(8)]
        v, v_next = w[D + _D.V], w_next[D + _D.V]
        cnt, cnt_next = w[D + _D.CNT], w_next[D + _D.CNT]
        ocnt, ocnt_next = w[D + _D.OCNT], w_next[D + _D.OCNT]
        emit_next = w_next[D + _D.EMIT]

        for j in range(NUM_CHALLENGES):
            out.append(alg.mul(s_d, alg.sub(ch_next[j], ch[j])))
        out.append(alg.mul(s_d, alg.sub(alg.mul(v_next, v_next), v_next)))
        out.append(alg.mul(s_d, alg.mul(v_next, _one_minus(alg, v))))
        out.append(alg.mul(s_d, alg.sub(cnt_next, alg.add(cnt, v_next))))

        # grand products
        for rep in range(2):
            base = rep * 9
            for k, enc_vals in ((0, u_next), (1, s_next)):
                term = ch[base + 8]
                for j in range(8):
                    term = alg.add(term, alg.mul(ch[base + j], enc_vals[j]))
                gated = alg.add(alg.mul(v_next, term), _one_minus(alg, v_next))
                acc = w[D + _D.ACC + 2 * rep + k]
                acc_n = w_next[D + _D.ACC + 2 * rep + k]
                out.append(alg.mul(s_d, alg.sub(acc_n, alg.mul(acc, gated))))

        # packed-limb decomposition (valid rows, via s_q on rows 1..cap)
        hb0 = [w[D + _D.HB0 + k] for k in range(4)]
        hb1 = [w[D + _D.HB1 + k] for k in range(4)]
        hb2 = [w[D + _D.HB2 + k] for k in range(4)]
        pb = [w[D + _D.PB + k] for k in range(4)]
        tb = [w[D + _D.TB + k] for k in range(4)]
        fb = w[D + _D.FB]
        sqv = alg.mul(s_q, v)

        def le_sum(bytes_, shift=0):
            acc_ = alg.mul_int(bytes_[0], 1 << shift)
            for k in range(1, len(bytes_)):
                acc_ = alg.add(acc_, alg.mul_int(bytes_[k],
                                                 1 << (shift + 8 * k)))
            return acc_

        # limb0 = h0 + pb0<<32 + pb1<<40 + pb2<<48
        l0 = alg.add(le_sum(hb0), le_sum(pb[:3], 32))
        out.append(alg.mul(sqv, alg.sub(s_cur[0], l0)))
        # limb1 = h1 + pb3<<32 + tb0<<40 + tb1<<48
        l1 = alg.add(le_sum(hb1), le_sum([pb[3], tb[0], tb[1]], 32))
        out.append(alg.mul(sqv, alg.sub(s_cur[1], l1)))
        # limb2 = h2 + tb2<<32 + tb3<<40 + fresh<<48
        l2 = alg.add(le_sum(hb2),
                     alg.add(le_sum([tb[2], tb[3]], 32),
                             alg.mul_int(fb, 1 << 48)))
        out.append(alg.mul(sqv, alg.sub(s_cur[2], l2)))
        out.append(alg.mul(s_q, alg.sub(alg.mul(fb, fb), fb)))

        # lexicographic adjacency over (h7..h0, ts), one-hot first-difference
        # selector on the NEXT row describing the step cur -> next
        dsel_n = [w_next[D + _D.DSEL + j] for j in range(NUM_CMP)]
        sdv = alg.mul(s_d, v_next)
        for j in range(NUM_CMP):
            out.append(alg.mul(s_d, alg.sub(alg.mul(dsel_n[j], dsel_n[j]),
                                            dsel_n[j])))
        onesum = dsel_n[0]
        for j in range(1, NUM_CMP):
            onesum = alg.add(onesum, dsel_n[j])
        out.append(alg.mul(sdv, alg.add_int(onesum, P - 1)))

        def cmp_limbs(row_w):
            """Comparison limbs [h7..h3 (raw limbs), h2, h1, h0, ts]."""
            hb0_r = [row_w[D + _D.HB0 + k] for k in range(4)]
            hb1_r = [row_w[D + _D.HB1 + k] for k in range(4)]
            hb2_r = [row_w[D + _D.HB2 + k] for k in range(4)]
            tb_r = [row_w[D + _D.TB + k] for k in range(4)]
            s_r = [row_w[D + _D.S_ENC + j] for j in range(8)]
            return [s_r[7], s_r[6], s_r[5], s_r[4], s_r[3],
                    le_sum(hb2_r), le_sum(hb1_r), le_sum(hb0_r),
                    le_sum(tb_r)]

        L_cur = cmp_limbs(w)
        L_nxt = cmp_limbs(w_next)
        prefix = None
        d_val = None
        for j in range(NUM_CMP):
            diff = alg.sub(L_nxt[j], L_cur[j])
            # limbs strictly before the difference position are equal
            if prefix is None:
                before = _one_minus(alg, dsel_n[j])
            else:
                before = _one_minus(alg, alg.add(prefix, dsel_n[j]))
            out.append(alg.mul(sdv, alg.mul(before, diff)))
            contrib = alg.mul(dsel_n[j], diff)
            d_val = contrib if d_val is None else alg.add(d_val, contrib)
            prefix = dsel_n[j] if prefix is None else alg.add(prefix,
                                                              dsel_n[j])
        # deciding difference >= 1 via d - 1 = 4 bytes (limbs < 2^32 << p)
        db_n = [w_next[D + _D.DB + k] for k in range(4)]
        out.append(alg.mul(sdv, alg.sub(d_val, alg.add_int(le_sum(db_n), 1))))

        # freshness: fresh' = 1 - same_hash' where same_hash' = dsel'[8]
        fb_next = w_next[D + _D.FB]
        out.append(alg.mul(sdv, alg.sub(fb_next,
                                        _one_minus(alg, dsel_n[8]))))
        # same hash => same memory page
        pb_n = [w_next[D + _D.PB + k] for k in range(4)]
        pg_cur = le_sum(pb)
        pg_nxt = le_sum(pb_n)
        out.append(alg.mul(alg.mul(sdv, dsel_n[8]),
                           alg.sub(pg_nxt, pg_cur)))

        # emission: fresh valid rows emit; output encodings equal sorted
        out.append(alg.mul(s_d, alg.sub(emit_next,
                                        alg.mul(v_next, fb_next))))
        out.append(alg.mul(s_d, alg.sub(ocnt_next,
                                        alg.add(ocnt, emit_next))))
        for j in range(8):
            out.append(alg.mul(alg.mul(s_d, emit_next),
                               alg.sub(o_next[j], s_next[j])))
        return out

    n_constraints = (geo.num_tiles * GATES_PER_TILE
                     + 3 * (tiles_per_queue - 1) * GATES_PER_CHAIN_LINK
                     + NUM_CHALLENGES + 3 + 4
                     + 4                       # limb decomposition + fb bool
                     + NUM_CMP + 1 + NUM_CMP + 1  # one-hot + prefix + diff
                     + 1 + 1                   # fresh rule + page agreement
                     + 2 + 8)                  # emit/ocnt + output staging

    pis: List[Tuple[int, int]] = []
    pis += [(D + _D.CH + j, 0) for j in range(NUM_CHALLENGES)]
    for strip in range(3):
        first = TILE_WIDTH * strip * tiles_per_queue
        last = TILE_WIDTH * ((strip + 1) * tiles_per_queue - 1)
        pis += [(first + i, 0) for i in range(8, T)]
        pis += [(last + i, n - 1) for i in range(T)]
    pis += [(D + _D.ACC + k, 0) for k in range(4)]
    pis += [(D + _D.ACC + k, cap) for k in range(4)]
    pis += [(D + _D.V, 0), (D + _D.CNT, 0), (D + _D.CNT, cap),
            (D + _D.OCNT, 0), (D + _D.OCNT, cap)]
    # previous instance's last sorted entry: its comparison context
    pis += [(D + _D.S_ENC + j, 0) for j in range(8)]
    pis += [(D + _D.HB0 + k, 0) for k in range(4)]
    pis += [(D + _D.HB1 + k, 0) for k in range(4)]
    pis += [(D + _D.HB2 + k, 0) for k in range(4)]
    pis += [(D + _D.PB + k, 0) for k in range(4)]
    pis += [(D + _D.TB + k, 0) for k in range(4)]

    byte_table = np.arange(256, dtype=object).reshape(256, 1)
    lookup_cols = ([D + _D.HB0 + k for k in range(4)]
                   + [D + _D.HB1 + k for k in range(4)]
                   + [D + _D.HB2 + k for k in range(4)]
                   + [D + _D.PB + k for k in range(4)]
                   + [D + _D.TB + k for k in range(4)]
                   + [D + _D.DB + k for k in range(4)])
    lookup_sets = tuple((0, (col,)) for col in lookup_cols)

    return pk.PlonkishIR(
        log_n=log_n, num_witness=geo.num_witness, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(byte_table,), lookup_sets=lookup_sets)


def _const_rows(geo: DecommittsGeometry) -> np.ndarray:
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


def _copy_pairs(geo: DecommittsGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """The setup's copy cycles as ordered cell pairs ((m, 2) arrays of
    (col, row)), in the order the JAX package's `_copy_cycles` lists them:
    per request q, the 8 encoding lanes of the three strips (dense row q+1
    <-> the sponge absorption row of request q), the validity triple
    (unsorted bv, sorted bv, dense v) as its two links, then the output
    strip's bv with the dense EMIT flag."""
    D = geo.dense_base
    B = geo.blocks_per_tile
    K = geo.tiles_per_queue
    q = np.arange(geo.capacity, dtype=np.int64)
    t, r = q // B, (q % B) * ROWS_PER_PERMUTATION
    ub = TILE_WIDTH * t
    sb = TILE_WIDTH * (K + t)
    ob = TILE_WIDTH * (2 * K + t)
    full = lambda col: np.full_like(q, col)
    a_col, a_row, b_col, b_row = [], [], [], []
    for j in range(8):
        for base, enc in ((ub, _D.U_ENC), (sb, _D.S_ENC), (ob, _D.O_ENC)):
            a_col.append(base + j)
            a_row.append(r)
            b_col.append(full(D + enc + j))
            b_row.append(q + 1)
    a_col += [ub + 12, sb + 12, ob + 12]
    a_row += [r, r, r]
    b_col += [sb + 12, full(D + _D.V), full(D + _D.EMIT)]
    b_row += [r, q + 1, q + 1]
    a = np.stack([np.stack(a_col, 1), np.stack(a_row, 1)], -1).reshape(-1, 2)
    b = np.stack([np.stack(b_col, 1), np.stack(b_row, 1)], -1).reshape(-1, 2)
    return a, b


def decommitts_setup(ir: pk.PlonkishIR, geo: DecommittsGeometry,
                     cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    wiring = pk.wire_copy_pairs(geo.n, *_copy_pairs(geo))
    return pk.build_setup(ir, _const_rows(geo).T, wiring, cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def _strip_columns(geo: DecommittsGeometry, encodings: np.ndarray,
                   active: np.ndarray, head_state: Sequence[int], device
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """Sponge witness for one strip with a (possibly gapped) activity mask.

    encodings: (capacity, 8) uint64; active: (capacity,) bool. Returns
    (tiles (tiles_per_queue, 13, n): per tile the 12 state lanes and bv,
    staged (capacity, 8) uint64): staged[q] is what block q's rate lanes
    hold at the block start — the element encoding for active blocks, the
    carried state for inactive ones (the value the dense O_ENC/U_ENC/S_ENC
    row must mirror to satisfy the static copy wiring).
    """
    n, cap = geo.n, geo.capacity
    act = np.flatnonzero(active)
    count = len(act)
    head = gl.from_int(np.array(list(head_state), dtype=object), device)
    enc = gl.from_u64(encodings[act], device)
    if count:
        states = simulate_states_full(enc, head)  # (count + 1, 12)
    else:
        states = head[None]
    # the state entering block q: after the active blocks before it
    before = torch.from_numpy(np.cumsum(active) - active).to(device)
    cur = states[before]                                   # (cap, 12)
    rows = cur[:, None, :].expand(cap, ROWS_PER_PERMUTATION, T).clone()
    if count:
        act_t = torch.from_numpy(act).to(device)
        # active block q absorbs [enc_q || capacity lanes of its state]
        inputs = torch.cat([enc, cur[act_t, 8:]], dim=1)
        valid = _block_rows_device(inputs)                 # (count, 32, 12)
        if not torch.equal(valid[count - 1, -1], states[count]):
            raise AssertionError(
                "sponge row expansion diverged from queue simulator")
        rows[act_t] = valid
    staged = gl.to_u64(rows[:, 0, :8])
    out = torch.zeros((geo.tiles_per_queue, T + 1, n), dtype=torch.int64,
                      device=device)
    out[:, :T] = rows.reshape(geo.tiles_per_queue, n, T).transpose(1, 2)
    bv = torch.from_numpy(active.astype(np.int64)).to(device)
    out[:, T] = bv.repeat_interleave(ROWS_PER_PERMUTATION).reshape(
        geo.tiles_per_queue, n)
    return out, staged


@dataclasses.dataclass
class DecommittsInstanceInputs:
    """One instance's closed-form-input payload."""
    unsorted_encodings: np.ndarray  # (count, 8)
    sorted_encodings: np.ndarray    # (count, 8)
    unsorted_head: Tuple[int, ...]  # 12-lane state
    sorted_head: Tuple[int, ...]
    output_head: Tuple[int, ...]
    challenges: Sequence[int]       # 18
    acc_in: Tuple[int, int, int, int]
    cnt_in: int
    ocnt_in: int
    prev_sorted_entry: Optional[Sequence[int]]  # 8-limb enc or None


def _split_limbs(enc: Sequence[int]):
    """(h0..h2 bytes x3, page bytes, ts bytes, fresh) from limbs 0..2."""
    e = [int(v) for v in enc]
    hb0 = [(e[0] >> (8 * k)) & 0xFF for k in range(4)]
    hb1 = [(e[1] >> (8 * k)) & 0xFF for k in range(4)]
    hb2 = [(e[2] >> (8 * k)) & 0xFF for k in range(4)]
    pb = [(e[0] >> (32 + 8 * k)) & 0xFF for k in range(3)] \
        + [(e[1] >> 32) & 0xFF]
    tb = [(e[1] >> (40 + 8 * k)) & 0xFF for k in range(2)] \
        + [(e[2] >> (32 + 8 * k)) & 0xFF for k in range(2)]
    fresh = (e[2] >> 48) & 1
    return hb0, hb1, hb2, pb, tb, fresh


def _cmp_limbs_of(enc: Sequence[int]):
    hb0, hb1, hb2, pb, tb, _ = _split_limbs(enc)
    h0 = sum(b << (8 * k) for k, b in enumerate(hb0))
    h1 = sum(b << (8 * k) for k, b in enumerate(hb1))
    h2 = sum(b << (8 * k) for k, b in enumerate(hb2))
    ts = sum(b << (8 * k) for k, b in enumerate(tb))
    e = [int(v) for v in enc]
    return [e[7], e[6], e[5], e[4], e[3], h2, h1, h0, ts]


def decommitts_witness(ir: pk.PlonkishIR, geo: DecommittsGeometry,
                       inst: DecommittsInstanceInputs, device=None) -> gl.GF:
    """Assemble the full witness matrix (num_witness, n) for one instance on
    `device` (`None` means the CUDA card)."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = inst.unsorted_encodings.shape[0]
    assert inst.sorted_encodings.shape[0] == count <= cap
    D = geo.dense_base
    K = geo.tiles_per_queue
    u_enc = np.asarray(inst.unsorted_encodings,
                       dtype=object).astype(np.uint64).reshape(-1, 8)
    s_enc = np.asarray(inst.sorted_encodings,
                       dtype=object).astype(np.uint64).reshape(-1, 8)

    # per-element flags over the sorted stream
    prev = ([int(v) % P for v in inst.prev_sorted_entry]
            if inst.prev_sorted_entry is not None else [0] * 8)
    prev_cmp = _cmp_limbs_of(prev) if inst.prev_sorted_entry is not None \
        else [0] * NUM_CMP
    emits, dsels, dbytes = [], [], []
    for i in range(count):
        cur_cmp = _cmp_limbs_of(s_enc[i])
        j = next((k for k in range(NUM_CMP)
                  if cur_cmp[k] != prev_cmp[k]), None)
        assert j is not None, "duplicate (hash, ts) in sorted stream"
        d = cur_cmp[j] - prev_cmp[j]
        assert 1 <= d < (1 << 32) + 1, "sorted stream out of order"
        _, _, _, _, _, fresh = _split_limbs(s_enc[i])
        assert fresh == (0 if j == NUM_CMP - 1 else 1), \
            "is_fresh flag inconsistent with sort order"
        if j == NUM_CMP - 1:
            # same hash: page must agree with the previous request
            _, _, _, pb_p, _, _ = _split_limbs(prev if i == 0
                                               else s_enc[i - 1])
            _, _, _, pb_c, _, _ = _split_limbs(s_enc[i])
            assert pb_p == pb_c, "duplicate request disagrees on page"
        emits.append(fresh)
        dsels.append(j)
        dbytes.append(d - 1)
        prev_cmp = cur_cmp

    # sponge strips
    enc_u = np.zeros((cap, 8), dtype=np.uint64)
    enc_s = np.zeros((cap, 8), dtype=np.uint64)
    enc_u[:count] = u_enc
    enc_s[:count] = s_enc
    act = np.arange(cap) < count
    act_o = np.zeros(cap, dtype=bool)
    act_o[:count] = np.array(emits, dtype=bool)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    sels = torch.from_numpy(_const_rows(geo)[:, C_SLIN:C_SINT + 1].T.astype(
        np.int64)).to(device)  # (3, n)
    staged = []
    for strip, (enc, active, head) in enumerate(
            ((enc_u, act, inst.unsorted_head), (enc_s, act, inst.sorted_head),
             (enc_s, act_o, inst.output_head))):
        tiles, stg = _strip_columns(geo, enc, active, head, device)
        staged.append(stg)
        for t in range(K):
            base = TILE_WIDTH * (strip * K + t)
            W[base:base + T + 1] = tiles[t]
            W[base + 13:base + 16] = sels * tiles[t, T]
        del tiles
    u_staged, s_staged, o_staged = staged

    # dense region, rows 0..cap
    Wd = np.zeros((DENSE_WIDTH, cap + 1), dtype=np.uint64)
    ch = [int(v) % P for v in inst.challenges]
    assert len(ch) == NUM_CHALLENGES
    Wd[_D.CH:_D.CH + NUM_CHALLENGES] = np.array(ch, dtype=np.uint64)[:, None]

    def put_limbs(row, enc):
        hb0, hb1, hb2, pb, tb, fresh = _split_limbs(enc)
        Wd[_D.HB0:_D.HB0 + 4, row] = hb0
        Wd[_D.HB1:_D.HB1 + 4, row] = hb1
        Wd[_D.HB2:_D.HB2 + 4, row] = hb2
        Wd[_D.PB:_D.PB + 4, row] = pb
        Wd[_D.TB:_D.TB + 4, row] = tb
        return fresh

    Wd[_D.S_ENC:_D.S_ENC + 8, 0] = prev
    put_limbs(0, prev)
    Wd[_D.V, 0] = 1
    Wd[_D.CNT, 0] = int(inst.cnt_in)
    Wd[_D.OCNT, 0] = int(inst.ocnt_in)
    acc = [int(a) % P for a in inst.acc_in]
    Wd[_D.ACC:_D.ACC + 4, 0] = acc
    # encodings: the valid elements, else what the strips staged
    Wd[_D.U_ENC:_D.U_ENC + 8, 1:] = np.where(act[:, None], enc_u, u_staged).T
    Wd[_D.S_ENC:_D.S_ENC + 8, 1:] = np.where(act[:, None], enc_s, s_staged).T
    Wd[_D.O_ENC:_D.O_ENC + 8, 1:] = o_staged.T
    Wd[_D.V, 1:count + 1] = 1
    Wd[_D.EMIT, 1:count + 1] = emits
    Wd[_D.CNT, 1:] = int(inst.cnt_in) + np.minimum(np.arange(1, cap + 1),
                                                   count)
    Wd[_D.OCNT, 1:] = int(inst.ocnt_in) + np.cumsum(Wd[_D.EMIT, 1:])
    for q in range(count):
        row = q + 1
        u = [int(v) for v in enc_u[q]]
        s = [int(v) for v in enc_s[q]]
        for rep in range(2):
            tu = (ch[rep * 9 + 8] + sum(ch[rep * 9 + j] * u[j]
                                        for j in range(8))) % P
            ts_ = (ch[rep * 9 + 8] + sum(ch[rep * 9 + j] * s[j]
                                         for j in range(8))) % P
            acc[2 * rep] = acc[2 * rep] * tu % P
            acc[2 * rep + 1] = acc[2 * rep + 1] * ts_ % P
        Wd[_D.ACC:_D.ACC + 4, row] = acc
        Wd[_D.FB, row] = put_limbs(row, s)
        Wd[_D.DSEL + dsels[q], row] = 1
        for k in range(4):
            Wd[_D.DB + k, row] = (dbytes[q] >> (8 * k)) & 0xFF
    Wd[_D.ACC:_D.ACC + 4, count + 1:] = np.array(acc, dtype=np.uint64)[:, None]
    W[D:D + DENSE_WIDTH, :cap + 1] = gl.from_u64(Wd, device)
    return W


def expected_public_inputs(geo: DecommittsGeometry,
                           inst: DecommittsInstanceInputs,
                           u_tail: Sequence[int], s_tail: Sequence[int],
                           o_tail: Sequence[int], acc_out: Sequence[int],
                           cnt_out: int, ocnt_out: int) -> List[int]:
    prev = ([int(v) % P for v in inst.prev_sorted_entry]
            if inst.prev_sorted_entry is not None else [0] * 8)
    out = [int(v) % P for v in inst.challenges]
    for head, tail in ((inst.unsorted_head, u_tail),
                       (inst.sorted_head, s_tail),
                       (inst.output_head, o_tail)):
        out += [int(v) % P for v in list(head)[8:]]
        out += [int(v) % P for v in tail]
    out += [int(v) % P for v in inst.acc_in]
    out += [int(v) % P for v in acc_out]
    out += [1, int(inst.cnt_in), int(cnt_out),
            int(inst.ocnt_in), int(ocnt_out)]
    out += prev
    hb0, hb1, hb2, pb, tb, _ = _split_limbs(prev)
    out += hb0 + hb1 + hb2 + pb + tb
    return out


def instance_inputs(inst_w, challenges: Sequence[int]
                    ) -> DecommittsInstanceInputs:
    """Bridge a witness-side DecommittsCircuitInstance (witness/sorters.py)
    into the circuit payload."""
    return DecommittsInstanceInputs(
        unsorted_encodings=np.asarray(inst_w.unsorted_encodings,
                                      dtype=object),
        sorted_encodings=np.asarray(inst_w.sorted_encodings, dtype=object),
        unsorted_head=tuple(inst_w.unsorted_queue_state[0]),
        sorted_head=tuple(inst_w.sorted_queue_state[0]),
        output_head=tuple(inst_w.output_queue_state[0]),
        challenges=list(challenges),
        acc_in=tuple(inst_w.accumulators_in),
        cnt_in=int(inst_w.num_items_in),
        ocnt_in=int(inst_w.out_items_in),
        prev_sorted_entry=inst_w.prev_sorted_entry)


def instance_public_inputs(geo: DecommittsGeometry, inst_w,
                           challenges: Sequence[int]) -> List[int]:
    inst = instance_inputs(inst_w, challenges)
    return expected_public_inputs(
        geo, inst,
        u_tail=inst_w.unsorted_queue_state[1],
        s_tail=inst_w.sorted_queue_state[1],
        o_tail=inst_w.output_queue_state[1],
        acc_out=inst_w.accumulators_out,
        cnt_out=inst_w.num_items_in + inst_w.num_items,
        ocnt_out=inst_w.out_items_in + inst_w.out_items)
