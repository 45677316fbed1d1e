"""Storage sorter circuit: REAL base-layer gate set (type 9).

Proves, for one instance of the storage sort+dedup argument (reference:
circuit_definitions base_layer storage_sorter / zkevm_circuits
storage_validity_by_grand_product + the witness decomposer
src/witness/individual_circuits/storage_sort_dedup.rs:12):

  1. three narrow Poseidon2 queue chains (input, sorted, output segments);
  2. two grand products over the 20-limb TIMESTAMPED log encodings
     (log_query.rs:400-427) agree: sorted is a permutation of input;
  3. the sorted stream strictly increases lexicographically in
     (shard, address, key, extended_timestamp) — a 15-limb one-hot
     first-difference comparison over byte-decomposed fields, with a 4-byte
     range check of the deciding difference minus one;
  4. per storage slot (cell), the write/rollback stack replay is enforced
     row by row: reads see the current value, forward writes push
     (read == current, current := written), rollback writes pop
     (written == current, current := read, depth >= 1), a depth counter
     with an is-zero gadget tracks the stack, and the
     did-read-at-depth-zero flag accumulates;
  5. at each cell end, the NET access is emitted into the output queue —
     a write query (initial -> current) if the value changed, a protective
     read if unchanged but read at depth zero, nothing otherwise — exactly
     circuit_sequencer_api/src/sort_storage_access.rs:19-260 semantics,
     with the output encoding rebuilt in-circuit from the cell state;
  6. FSM continuation: queue tails, accumulators, counts, and the previous
     instance's last sorted encoding are public inputs; an instance NEVER
     starts inside a cell (s_first * V1 * SC1 = 0), so honest cell-boundary
     splits are the only satisfiable ones and no mid-cell state crosses
     instances.

Layout mirrors circuits/events_sorter_circuit.py: three narrow sponge
regions (96-row elements) + a dense region with one row per element
(row r = sorted element r-1; the emission of element r's cell lands in
output slot r+1 — decidable only once element r+1 is visible). Every packed
limb of the sorted encoding is decomposed into byte columns (134 byte
lookups per row) so field extraction is injective mod p.

The port's differences are those of circuits/narrow_region.py (stacked
tiles, copy wiring as cell pairs, the witness on the device); the dense
region is built in numpy, with per-element Python only over the valid
elements (the cell-stack replay is serial by nature).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import T
from ..prover import plonkish as pk
from . import narrow_region as nrr
from . import poseidon2_circuit as p2c

P = gl.P
NUM_REPETITIONS = 2
ENC_W = nrr.ENC_WIDTH                           # 20
NUM_CHALLENGES = NUM_REPETITIONS * (ENC_W + 1)  # 42
NUM_CMP = 15  # shard, addr words a4..a0, key words k7..k0, ext_ts


class _D:
    """Dense-region column offsets."""
    CH = 0
    IENC = 42
    SENC = 62
    OENC = 82
    ACC = 102      # lhs0, rhs0, lhs1, rhs1
    V = 106
    CNT = 107
    OCNT = 108
    EMIT = 109
    KB = 110       # 32 key bytes (LE)
    AB = 142       # 20 address bytes (LE)
    RVB = 162      # 32 read-value bytes (LE)
    WVB = 194      # 32 written-value bytes (LE)
    TSB = 226      # 4 timestamp bytes
    TXB = 230      # 4 tx-number bytes
    AUXB = 234     # aux byte
    SHB = 235      # shard byte
    ETB = 236      # 4 extended-timestamp bytes
    RW = 240
    SVC = 241
    RB = 242
    CURW = 243     # 8 current-value words
    INW = 251      # 8 initial-value words
    DEP = 259      # write-stack depth
    ZD = 260       # depth == 0 indicator
    ZINV = 261     # inverse witness for (1 - ZD) = DEP * ZINV
    RDZ = 262      # did-read-at-depth-zero flag
    EQZ = 263      # 8 per-word initial==current indicators
    EQI = 271      # 8 inverse witnesses
    EQA = 279
    EQB = 280
    EQ = 281
    DSEL = 282     # 15 one-hot first-difference selectors
    DB = 297       # 4 bytes of deciding diff minus 1
    TIN_IN = 301
    TOUT_IN = 305
    TIN_SRT = 309
    TOUT_SRT = 313
    TIN_OUT = 317
    TOUT_OUT = 321


DENSE_WIDTH = 325

# const columns
C_RC = 0
C_SLIN, C_SEXT, C_SINT = T, T + 1, T + 2
C_CE, C_EE = T + 3, T + 4
C_SD, C_SE, C_ST, C_SQ, C_SDC = T + 5, T + 6, T + 7, T + 8, T + 9
C_SFIRST, C_SVEND = T + 10, T + 11
NUM_CONST = T + 12


@dataclasses.dataclass(frozen=True)
class StorageGeometry:
    log_n: int
    tiles: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def region(self) -> nrr.NarrowGeometry:
        return nrr.NarrowGeometry(self.log_n, self.tiles)

    @property
    def slots(self) -> int:
        return self.region.capacity

    @property
    def capacity(self) -> int:
        """Elements per instance (one region slot is the emission lag)."""
        return self.slots - 1

    @property
    def dense_base(self) -> int:
        return 3 * nrr.TILE_WIDTH * self.tiles

    @property
    def num_witness(self) -> int:
        return self.dense_base + DENSE_WIDTH


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


def storage_ir(log_n: int, tiles: int = 1) -> pk.PlonkishIR:
    geo = StorageGeometry(log_n, tiles)
    n, cap = geo.n, geo.capacity
    assert cap + 2 <= n and cap >= 1
    assert n >= 256, "byte lookup table needs 256 rows"
    D = geo.dense_base
    rg = geo.region

    def eval_gates(alg, w, w_next, c):
        out = []
        for q in range(3):
            out += nrr.narrow_region_gates(
                alg, w, w_next, c, q * nrr.TILE_WIDTH * tiles, rg,
                C_RC, C_SLIN, C_SEXT, C_SINT, C_CE, C_EE)

        s_d, s_e, s_t, s_q, s_dc = (c[C_SD], c[C_SE], c[C_ST], c[C_SQ],
                                    c[C_SDC])
        s_first, s_vend = c[C_SFIRST], c[C_SVEND]
        ch = [w[D + _D.CH + j] for j in range(NUM_CHALLENGES)]
        ch_next = [w_next[D + _D.CH + j] for j in range(NUM_CHALLENGES)]
        ienc_n = [w_next[D + _D.IENC + j] for j in range(ENC_W)]
        senc = [w[D + _D.SENC + j] for j in range(ENC_W)]
        senc_n = [w_next[D + _D.SENC + j] for j in range(ENC_W)]
        oenc_n = [w_next[D + _D.OENC + j] for j in range(ENC_W)]
        v, v_n = w[D + _D.V], w_next[D + _D.V]
        cnt, cnt_n = w[D + _D.CNT], w_next[D + _D.CNT]
        ocnt, ocnt_n = w[D + _D.OCNT], w_next[D + _D.OCNT]
        emit_n = w_next[D + _D.EMIT]

        # challenges constant; validity boolean+monotone; count
        for j in range(NUM_CHALLENGES):
            out.append(alg.mul(s_d, alg.sub(ch_next[j], ch[j])))
        out.append(alg.mul(s_d, alg.sub(alg.mul(v_n, v_n), v_n)))
        out.append(alg.mul(s_d, alg.mul(v_n, _one_minus(alg, v))))
        out.append(alg.mul(s_d, alg.sub(cnt_n, alg.add(cnt, v_n))))

        # grand products
        for rep in range(NUM_REPETITIONS):
            base = rep * (ENC_W + 1)
            for k, enc_vals in ((0, ienc_n), (1, senc_n)):
                term = ch[base + ENC_W]
                for j in range(ENC_W):
                    term = alg.add(term, alg.mul(ch[base + j], enc_vals[j]))
                gated = alg.add(alg.mul(v_n, term), _one_minus(alg, v_n))
                acc = w[D + _D.ACC + 2 * rep + k]
                acc_n = w_next[D + _D.ACC + 2 * rep + k]
                out.append(alg.mul(s_d, alg.sub(acc_n, alg.mul(acc, gated))))

        # ---- packed-limb decomposition (rows 0..cap via s_dc, gated v) ----
        def col(off, k=0):
            return w[D + off + k]

        def le(cols, shift=0):
            acc_ = alg.mul_int(cols[0], 1 << shift)
            for k in range(1, len(cols)):
                acc_ = alg.add(acc_, alg.mul_int(cols[k],
                                                 1 << (shift + 8 * k)))
            return acc_

        kb = [col(_D.KB, k) for k in range(32)]
        ab = [col(_D.AB, k) for k in range(20)]
        rvb = [col(_D.RVB, k) for k in range(32)]
        wvb = [col(_D.WVB, k) for k in range(32)]
        tsb = [col(_D.TSB, k) for k in range(4)]
        txb = [col(_D.TXB, k) for k in range(4)]
        auxb, shb = col(_D.AUXB), col(_D.SHB)
        etb = [col(_D.ETB, k) for k in range(4)]
        rw, svc, rb = col(_D.RW), col(_D.SVC), col(_D.RB)
        sdcv = alg.mul(s_dc, v)
        # limbs 0..7: rv word j + key bytes 3j..3j+2
        for j in range(8):
            limb = alg.add(le(rvb[4 * j:4 * j + 4]),
                           le(kb[3 * j:3 * j + 3], 32))
            out.append(alg.mul(sdcv, alg.sub(senc[j], limb)))
        # limbs 8..9: wv words 0..1 + key bytes 24..29
        for i in range(2):
            limb = alg.add(le(wvb[4 * i:4 * i + 4]),
                           le(kb[24 + 3 * i:27 + 3 * i], 32))
            out.append(alg.mul(sdcv, alg.sub(senc[8 + i], limb)))
        # limb 10: wv word 2 + key bytes 30..31 + address byte 0
        limb = alg.add(le(wvb[8:12]), le([kb[30], kb[31], ab[0]], 32))
        out.append(alg.mul(sdcv, alg.sub(senc[10], limb)))
        # limbs 11..15: wv words 3..7 + address bytes 1+3i..3+3i
        for i in range(5):
            limb = alg.add(le(wvb[12 + 4 * i:16 + 4 * i]),
                           le(ab[1 + 3 * i:4 + 3 * i], 32))
            out.append(alg.mul(sdcv, alg.sub(senc[11 + i], limb)))
        # limb 16: ts + address bytes 16..18
        limb = alg.add(le(tsb), le(ab[16:19], 32))
        out.append(alg.mul(sdcv, alg.sub(senc[16], limb)))
        # limb 17: tx + address byte 19 + aux + shard
        limb = alg.add(le(txb), le([ab[19], auxb, shb], 32))
        out.append(alg.mul(sdcv, alg.sub(senc[17], limb)))
        # limb 18 = rw + 2*svc; limb 19 = rb + ext_ts << 8
        out.append(alg.mul(sdcv, alg.sub(
            senc[18], alg.add(rw, alg.mul_int(svc, 2)))))
        out.append(alg.mul(sdcv, alg.sub(senc[19], alg.add(rb, le(etb, 8)))))
        for flag in (rw, svc, rb):
            out.append(alg.mul(s_dc, alg.sub(alg.mul(flag, flag), flag)))
        # rollback only applies to writes
        out.append(alg.mul(sdcv, alg.mul(rb, _one_minus(alg, rw))))

        # ---- 15-limb lexicographic comparison (step r -> r+1) -------------
        def cmp_limbs(row_w):
            kb_r = [row_w[D + _D.KB + k] for k in range(32)]
            ab_r = [row_w[D + _D.AB + k] for k in range(20)]
            etb_r = [row_w[D + _D.ETB + k] for k in range(4)]

            def le_r(cols):
                acc_ = cols[0]
                for k in range(1, len(cols)):
                    acc_ = alg.add(acc_, alg.mul_int(cols[k], 1 << (8 * k)))
                return acc_

            addr_words = [le_r(ab_r[4 * i:4 * i + 4]) for i in range(5)]
            key_words = [le_r(kb_r[4 * i:4 * i + 4]) for i in range(8)]
            return ([row_w[D + _D.SHB]] + addr_words[::-1]
                    + key_words[::-1] + [le_r(etb_r)])

        dsel_n = [w_next[D + _D.DSEL + j] for j in range(NUM_CMP)]
        sdv = alg.mul(s_d, v_n)
        for j in range(NUM_CMP):
            out.append(alg.mul(s_d, alg.sub(alg.mul(dsel_n[j], dsel_n[j]),
                                            dsel_n[j])))
        onesum = dsel_n[0]
        for j in range(1, NUM_CMP):
            onesum = alg.add(onesum, dsel_n[j])
        out.append(alg.mul(sdv, alg.add_int(onesum, P - 1)))
        L_cur = cmp_limbs(w)
        L_nxt = cmp_limbs(w_next)
        prefix = None
        d_val = None
        for j in range(NUM_CMP):
            diff = alg.sub(L_nxt[j], L_cur[j])
            if prefix is None:
                before = _one_minus(alg, dsel_n[j])
            else:
                before = _one_minus(alg, alg.add(prefix, dsel_n[j]))
            out.append(alg.mul(sdv, alg.mul(before, diff)))
            contrib = alg.mul(dsel_n[j], diff)
            d_val = contrib if d_val is None else alg.add(d_val, contrib)
            prefix = dsel_n[j] if prefix is None else alg.add(prefix,
                                                              dsel_n[j])
        db_n = [w_next[D + _D.DB + k] for k in range(4)]
        db_sum = db_n[0]
        for k in range(1, 4):
            db_sum = alg.add(db_sum, alg.mul_int(db_n[k], 1 << (8 * k)))
        out.append(alg.mul(sdv, alg.sub(d_val, alg.add_int(db_sum, 1))))
        sc_n = dsel_n[NUM_CMP - 1]  # same cell <=> diff at the ext_ts limb

        # ---- cell-state replay (step r -> r+1) -----------------------------
        rw_n, rb_n = w_next[D + _D.RW], w_next[D + _D.RB]
        dep, dep_n = w[D + _D.DEP], w_next[D + _D.DEP]
        zd, zd_n = w[D + _D.ZD], w_next[D + _D.ZD]
        zinv_n = w_next[D + _D.ZINV]
        rdz, rdz_n = w[D + _D.RDZ], w_next[D + _D.RDZ]
        same = alg.mul(sdv, sc_n)
        new = alg.mul(sdv, _one_minus(alg, sc_n))
        # a cell never starts with a rollback
        out.append(alg.mul(new, alg.mul(rw_n, rb_n)))
        # rollback pops: requires depth >= 1 before (zd at row r is 0)
        out.append(alg.mul(same, alg.mul(alg.mul(rw_n, rb_n), zd)))
        # depth: new cell -> rw'; same cell -> dep + rw'(1-rb') - rw' rb'
        out.append(alg.mul(new, alg.sub(dep_n, rw_n)))
        delta = alg.sub(alg.mul(rw_n, _one_minus(alg, rb_n)),
                        alg.mul(rw_n, rb_n))
        out.append(alg.mul(same, alg.sub(dep_n, alg.add(dep, delta))))
        # is-zero gadget for depth (rows 1..cap via s_q... use s_q on next)
        out.append(alg.mul(s_d, alg.sub(alg.mul(zd_n, zd_n), zd_n)))
        out.append(alg.mul(s_d, alg.mul(dep_n, zd_n)))
        out.append(alg.mul(s_d, alg.sub(_one_minus(alg, zd_n),
                                        alg.mul(dep_n, zinv_n))))
        # read-at-depth-zero flag
        read_n = _one_minus(alg, rw_n)
        hit = alg.mul(read_n, zd_n)
        out.append(alg.mul(new, alg.sub(rdz_n, hit)))
        or_ = alg.sub(alg.add(rdz, hit), alg.mul(rdz, hit))
        out.append(alg.mul(same, alg.sub(rdz_n, or_)))

        # value chaining per word
        curw = [w[D + _D.CURW + j] for j in range(8)]
        curw_n = [w_next[D + _D.CURW + j] for j in range(8)]
        inw = [w[D + _D.INW + j] for j in range(8)]
        inw_n = [w_next[D + _D.INW + j] for j in range(8)]
        rvb_n = [w_next[D + _D.RVB + k] for k in range(32)]
        wvb_n = [w_next[D + _D.WVB + k] for k in range(32)]

        def word(bytes_, j):
            acc_ = bytes_[4 * j]
            for k in range(1, 4):
                acc_ = alg.add(acc_, alg.mul_int(bytes_[4 * j + k],
                                                 1 << (8 * k)))
            return acc_

        fwd_w = alg.mul(rw_n, _one_minus(alg, rb_n))
        for j in range(8):
            rv_j = word(rvb_n, j)
            wv_j = word(wvb_n, j)
            # same cell: non-rollback rows see current in read_value;
            # rollback rows see current in written_value
            out.append(alg.mul(alg.mul(same, _one_minus(alg, rb_n)),
                               alg.sub(rv_j, curw[j])))
            out.append(alg.mul(alg.mul(same, rb_n), alg.sub(wv_j, curw[j])))
            # current := fwd-write ? written : read (covers read + rollback)
            sel = alg.add(alg.mul(fwd_w, wv_j),
                          alg.mul(_one_minus(alg, fwd_w), rv_j))
            out.append(alg.mul(sdv, alg.sub(curw_n[j], sel)))
            # initial: new cell -> read_value; same cell -> carried
            out.append(alg.mul(new, alg.sub(inw_n[j], rv_j)))
            out.append(alg.mul(same, alg.sub(inw_n[j], inw[j])))

        # ---- initial == current equality gadget (row-local, via s_q) ------
        eqz = [w[D + _D.EQZ + j] for j in range(8)]
        eqi = [w[D + _D.EQI + j] for j in range(8)]
        eqa, eqb, eq = w[D + _D.EQA], w[D + _D.EQB], w[D + _D.EQ]
        sqv = alg.mul(s_q, v)
        for j in range(8):
            dw = alg.sub(inw[j], curw[j])
            out.append(alg.mul(s_q, alg.sub(alg.mul(eqz[j], eqz[j]), eqz[j])))
            out.append(alg.mul(sqv, alg.mul(dw, eqz[j])))
            out.append(alg.mul(sqv, alg.sub(_one_minus(alg, eqz[j]),
                                            alg.mul(dw, eqi[j]))))
        out.append(alg.mul(s_q, alg.sub(
            eqa, alg.mul(alg.mul(eqz[0], eqz[1]), alg.mul(eqz[2], eqz[3])))))
        out.append(alg.mul(s_q, alg.sub(
            eqb, alg.mul(alg.mul(eqz[4], eqz[5]), alg.mul(eqz[6], eqz[7])))))
        out.append(alg.mul(s_q, alg.sub(eq, alg.mul(eqa, eqb))))

        # ---- emission (cell of row r ends at r -> output slot r+1) --------
        last = _one_minus(alg, alg.mul(sc_n, v_n))
        obs = _one_minus(alg, alg.mul(eq, _one_minus(alg, rdz)))
        rule = alg.mul(alg.mul(v, last), obs)
        out.append(alg.mul(s_e, alg.sub(emit_n, rule)))
        out.append(alg.mul(s_t, alg.sub(ocnt_n, alg.add(ocnt, emit_n))))

        # emitted output encoding: the NET query of row r's cell
        semit = alg.mul(s_e, emit_n)
        for j in range(8):
            limb = alg.add(inw[j], le(kb[3 * j:3 * j + 3], 32))
            out.append(alg.mul(semit, alg.sub(oenc_n[j], limb)))
        for i in range(2):
            limb = alg.add(curw[i], le(kb[24 + 3 * i:27 + 3 * i], 32))
            out.append(alg.mul(semit, alg.sub(oenc_n[8 + i], limb)))
        limb = alg.add(curw[2], le([kb[30], kb[31], ab[0]], 32))
        out.append(alg.mul(semit, alg.sub(oenc_n[10], limb)))
        for i in range(5):
            limb = alg.add(curw[3 + i], le(ab[1 + 3 * i:4 + 3 * i], 32))
            out.append(alg.mul(semit, alg.sub(oenc_n[11 + i], limb)))
        out.append(alg.mul(semit, alg.sub(oenc_n[16], le(ab[16:19], 32))))
        out.append(alg.mul(semit, alg.sub(oenc_n[17],
                                          le([ab[19], auxb, shb], 32))))
        out.append(alg.mul(semit, alg.sub(oenc_n[18], _one_minus(alg, eq))))
        out.append(alg.mul(semit, oenc_n[19]))

        # ---- boundary rows (s_first sits on row 1, read via w) -------------
        sc_cur = w[D + _D.DSEL + NUM_CMP - 1]
        out.append(alg.mul(s_first, alg.mul(v, sc_cur)))  # no mid-cell splits
        out.append(alg.mul(s_first, w[D + _D.EMIT]))      # slot 1 is dead
        out.append(alg.mul(s_vend, v))                  # slot cap+1 inactive

        # tail registers (mux chains over rows 0..cap)
        for tin_c, tout_c, act_n in ((_D.TIN_IN, _D.TOUT_IN, v_n),
                                     (_D.TIN_SRT, _D.TOUT_SRT, v_n),
                                     (_D.TIN_OUT, _D.TOUT_OUT, emit_n)):
            for k in range(4):
                tin = w[D + tin_c + k]
                tin_nx = w_next[D + tin_c + k]
                tout = w[D + tout_c + k]
                mux = alg.add(alg.mul(act_n, tout),
                              alg.mul(_one_minus(alg, act_n), tin))
                out.append(alg.mul(s_t, alg.sub(tin_nx, mux)))
        return out

    n_constraints = (3 * tiles * nrr.NUM_GATES_PER_TILE
                     + NUM_CHALLENGES + 3 + 4          # dense chains
                     + 20 + 3 + 1                      # limb decomposition
                     + NUM_CMP + 1 + NUM_CMP + 1       # lex comparison
                     + 2 + 2 + 3 + 2                   # depth/rdz machinery
                     + 8 * 5                           # value chaining
                     + 8 * 3 + 3                       # equality gadget
                     + 2 + 20                          # emission + oenc
                     + 3 + 12)                         # boundaries + tails

    pis: List[Tuple[int, int]] = []
    D_ = geo.dense_base
    pis += [(D_ + _D.CH + j, 0) for j in range(NUM_CHALLENGES)]
    for tin_c in (_D.TIN_IN, _D.TIN_SRT, _D.TIN_OUT):
        pis += [(D_ + tin_c + k, 0) for k in range(4)]
        pis += [(D_ + tin_c + k, cap + 1) for k in range(4)]
    pis += [(D_ + _D.ACC + k, 0) for k in range(4)]
    pis += [(D_ + _D.ACC + k, cap) for k in range(4)]
    pis += [(D_ + _D.V, 0), (D_ + _D.CNT, 0), (D_ + _D.CNT, cap),
            (D_ + _D.OCNT, 0), (D_ + _D.OCNT, cap + 1)]
    # previous instance's last sorted encoding (comparison context row 0;
    # its byte decomposition is enforced by the s_dc row-0 constraints)
    pis += [(D_ + _D.SENC + j, 0) for j in range(ENC_W)]

    byte_table = np.arange(256, dtype=object).reshape(256, 1)
    lookup_cols = ([D_ + _D.KB + k for k in range(32)]
                   + [D_ + _D.AB + k for k in range(20)]
                   + [D_ + _D.RVB + k for k in range(32)]
                   + [D_ + _D.WVB + k for k in range(32)]
                   + [D_ + _D.TSB + k for k in range(4)]
                   + [D_ + _D.TXB + k for k in range(4)]
                   + [D_ + _D.AUXB, D_ + _D.SHB]
                   + [D_ + _D.ETB + k for k in range(4)]
                   + [D_ + _D.DB + k for k in range(4)])
    lookup_sets = tuple((0, (col,)) for col in lookup_cols)

    return pk.PlonkishIR(
        log_n=log_n, num_witness=geo.num_witness, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(byte_table,), lookup_sets=lookup_sets)


def _const_rows(geo: StorageGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n, cap = geo.n, geo.capacity
    rows = np.zeros((n, NUM_CONST), dtype=np.uint64)
    block = p2c._block_const_rows().astype(np.uint64)  # (32, 15)
    rows[:, :T + 3] = np.tile(block, (n // nrr.ROWS_PER_PERMUTATION, 1))
    rows[:, T + 3:T + 5] = nrr.narrow_cadence_const(geo.region)
    rows[0:cap, C_SD] = 1
    rows[1:cap + 1, C_SE] = 1
    rows[0:cap + 1, C_ST] = 1
    rows[1:cap + 1, C_SQ] = 1
    rows[0:cap + 1, C_SDC] = 1
    rows[1, C_SFIRST] = 1
    rows[cap + 1, C_SVEND] = 1
    return rows


def _copy_pairs(geo: StorageGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """The setup's copy cycles as ordered cell pairs, region by region."""
    D = geo.dense_base
    rg = geo.region
    pairs = []
    regions = ((0, _D.IENC, _D.V, _D.TIN_IN, _D.TOUT_IN),
               (1, _D.SENC, _D.V, _D.TIN_SRT, _D.TOUT_SRT),
               (2, _D.OENC, _D.EMIT, _D.TIN_OUT, _D.TOUT_OUT))
    for q, enc_c, bv_c, tin_c, tout_c in regions:
        pairs.append(nrr.narrow_region_copy_cycles(
            q * nrr.TILE_WIDTH * geo.tiles, rg, geo.slots,
            enc_cell=lambda s, j, ec=enc_c: (D + ec + j, s + 1),
            bv_cell=lambda s, bc=bv_c: (D + bc, s + 1),
            tin_cell=lambda s, k, tc=tin_c: (D + tc + k, s),
            tout_cell=lambda s, k, tc=tout_c: (D + tc + k, s)))
    return (np.concatenate([a for a, _ in pairs]),
            np.concatenate([b for _, b in pairs]))


def storage_setup(ir: pk.PlonkishIR, geo: StorageGeometry,
                  cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    wiring = pk.wire_copy_pairs(geo.n, *_copy_pairs(geo))
    return pk.build_setup(ir, _const_rows(geo).T, wiring, cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def _decompose(enc: Sequence[int]) -> Dict[str, object]:
    """Byte/flag decomposition of one timestamped log encoding."""
    e = [int(v) for v in enc]
    rvb = []
    kb = []
    for j in range(8):
        rvb += [(e[j] >> (8 * k)) & 0xFF for k in range(4)]
        kb += [(e[j] >> (32 + 8 * k)) & 0xFF for k in range(3)]
    wvb = []
    for i in range(2):
        wvb += [(e[8 + i] >> (8 * k)) & 0xFF for k in range(4)]
        kb += [(e[8 + i] >> (32 + 8 * k)) & 0xFF for k in range(3)]
    wvb += [(e[10] >> (8 * k)) & 0xFF for k in range(4)]
    kb += [(e[10] >> 32) & 0xFF, (e[10] >> 40) & 0xFF]
    ab = [(e[10] >> 48) & 0xFF]
    for i in range(5):
        wvb += [(e[11 + i] >> (8 * k)) & 0xFF for k in range(4)]
        ab += [(e[11 + i] >> (32 + 8 * k)) & 0xFF for k in range(3)]
    tsb = [(e[16] >> (8 * k)) & 0xFF for k in range(4)]
    ab += [(e[16] >> (32 + 8 * k)) & 0xFF for k in range(3)]
    txb = [(e[17] >> (8 * k)) & 0xFF for k in range(4)]
    ab += [(e[17] >> 32) & 0xFF]
    auxb = (e[17] >> 40) & 0xFF
    shb = (e[17] >> 48) & 0xFF
    rw = e[18] & 1
    svc = (e[18] >> 1) & 1
    rb = e[19] & 1
    etb = [(e[19] >> (8 + 8 * k)) & 0xFF for k in range(4)]
    assert len(kb) == 32 and len(ab) == 20
    assert e[18] == rw + 2 * svc and e[19] == rb + (
        sum(b << (8 * k) for k, b in enumerate(etb)) << 8)
    rvw = [sum(rvb[4 * j + k] << (8 * k) for k in range(4)) for j in range(8)]
    wvw = [sum(wvb[4 * j + k] << (8 * k) for k in range(4)) for j in range(8)]
    return dict(kb=kb, ab=ab, rvb=rvb, wvb=wvb, tsb=tsb, txb=txb,
                auxb=auxb, shb=shb, etb=etb, rw=rw, svc=svc, rb=rb,
                rvw=rvw, wvw=wvw)


def _cmp_limbs(dec: Dict[str, object]) -> List[int]:
    ab, kb, etb = dec["ab"], dec["kb"], dec["etb"]
    aw = [sum(ab[4 * i + k] << (8 * k) for k in range(4)) for i in range(5)]
    kw = [sum(kb[4 * i + k] << (8 * k) for k in range(4)) for i in range(8)]
    ets = sum(etb[k] << (8 * k) for k in range(4))
    return [dec["shb"]] + aw[::-1] + kw[::-1] + [ets]


def _net_encoding(dec: Dict[str, object], inw: Sequence[int],
                  curw: Sequence[int], eq: int) -> List[int]:
    """The output encoding of a cell's NET access: initial value as read,
    current value as written, the cell's key and address bytes, rw = not
    eq (circuit_sequencer_api sort_storage_access.rs semantics)."""
    kb, ab = dec["kb"], dec["ab"]
    oe = [0] * ENC_W
    for j in range(8):
        oe[j] = inw[j] | (kb[3 * j] << 32) | (kb[3 * j + 1] << 40) \
            | (kb[3 * j + 2] << 48)
    for i in range(2):
        oe[8 + i] = curw[i] | (kb[24 + 3 * i] << 32) \
            | (kb[25 + 3 * i] << 40) | (kb[26 + 3 * i] << 48)
    oe[10] = curw[2] | (kb[30] << 32) | (kb[31] << 40) | (ab[0] << 48)
    for i in range(5):
        oe[11 + i] = curw[3 + i] | (ab[1 + 3 * i] << 32) \
            | (ab[2 + 3 * i] << 40) | (ab[3 + 3 * i] << 48)
    oe[16] = (ab[16] << 32) | (ab[17] << 40) | (ab[18] << 48)
    oe[17] = (ab[19] << 32) | (dec["auxb"] << 40) | (dec["shb"] << 48)
    oe[18] = 1 - eq
    oe[19] = 0
    return oe


@dataclasses.dataclass
class StorageInstanceInputs:
    """One instance's closed-form-input payload."""
    input_encodings: np.ndarray   # (count, 20)
    sorted_encodings: np.ndarray  # (count, 20)
    input_head: Tuple[int, ...]   # 4-element narrow tails
    sorted_head: Tuple[int, ...]
    output_head: Tuple[int, ...]
    challenges: Sequence[int]     # 42
    acc_in: Tuple[int, int, int, int]
    cnt_in: int
    ocnt_in: int
    prev_enc: Optional[Sequence[int]]  # 20-limb or None


def storage_witness(ir: pk.PlonkishIR, geo: StorageGeometry,
                    inst: StorageInstanceInputs, device=None) -> gl.GF:
    """The witness (num_witness, n) on `device` (`None` means the CUDA
    card): the dense region's rows 0..cap+1 in numpy, with per-element
    Python over the valid elements only (the cell-stack replay is serial),
    the three sponge regions by `narrow_region_witness`."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = inst.input_encodings.shape[0]
    assert inst.sorted_encodings.shape[0] == count <= cap
    D = geo.dense_base
    Wd = np.zeros((DENSE_WIDTH, cap + 2), dtype=np.uint64)

    ch = [int(v) % P for v in inst.challenges]
    assert len(ch) == NUM_CHALLENGES
    Wd[_D.CH:_D.CH + NUM_CHALLENGES, 0:cap + 1] = \
        np.array(ch, dtype=np.uint64)[:, None]
    Wd[_D.V, 0] = 1
    Wd[_D.OCNT, 0] = int(inst.ocnt_in)
    acc = [int(a) % P for a in inst.acc_in]
    Wd[_D.ACC:_D.ACC + 4, 0] = acc

    def put_dec(row, dec):
        for off, key in ((_D.KB, "kb"), (_D.AB, "ab"), (_D.RVB, "rvb"),
                         (_D.WVB, "wvb"), (_D.TSB, "tsb"), (_D.TXB, "txb"),
                         (_D.ETB, "etb")):
            Wd[off:off + len(dec[key]), row] = dec[key]
        for off, key in ((_D.AUXB, "auxb"), (_D.SHB, "shb"), (_D.RW, "rw"),
                         (_D.SVC, "svc"), (_D.RB, "rb")):
            Wd[off, row] = dec[key]

    prev_enc = ([int(v) % P for v in inst.prev_enc]
                if inst.prev_enc is not None else [0] * ENC_W)
    prev_dec = _decompose(prev_enc)
    Wd[_D.SENC:_D.SENC + ENC_W, 0] = prev_enc
    put_dec(0, prev_dec)
    prev_cmp = _cmp_limbs(prev_dec) if inst.prev_enc is not None \
        else [0] * NUM_CMP

    # replay state
    curw = [0] * 8
    inw = [0] * 8
    dep = 0
    rdz = 0
    decs = []
    for i in range(count):
        r = i + 1
        ie = [int(v) for v in inst.input_encodings[i]]
        se = [int(v) for v in inst.sorted_encodings[i]]
        Wd[_D.IENC:_D.IENC + ENC_W, r] = ie
        Wd[_D.SENC:_D.SENC + ENC_W, r] = se
        Wd[_D.V, r] = 1
        for rep in range(NUM_REPETITIONS):
            base = rep * (ENC_W + 1)
            ti = (ch[base + ENC_W] + sum(ch[base + j] * ie[j]
                                         for j in range(ENC_W))) % P
            ts_ = (ch[base + ENC_W] + sum(ch[base + j] * se[j]
                                          for j in range(ENC_W))) % P
            acc[2 * rep] = acc[2 * rep] * ti % P
            acc[2 * rep + 1] = acc[2 * rep + 1] * ts_ % P
        Wd[_D.ACC:_D.ACC + 4, r] = acc

        dec = _decompose(se)
        decs.append(dec)
        put_dec(r, dec)
        cur_cmp = _cmp_limbs(dec)
        j = next((k for k in range(NUM_CMP)
                  if cur_cmp[k] != prev_cmp[k]), None)
        assert j is not None, "duplicate (cell, ext_ts) in sorted stream"
        d = cur_cmp[j] - prev_cmp[j]
        assert 1 <= d < (1 << 32) + 1, "sorted stream out of order"
        same = (j == NUM_CMP - 1)
        if i == 0:
            assert not same, "instance must not start inside a cell"
        Wd[_D.DSEL + j, r] = 1
        for k in range(4):
            Wd[_D.DB + k, r] = ((d - 1) >> (8 * k)) & 0xFF

        rw, rb = dec["rw"], dec["rb"]
        rvw, wvw = dec["rvw"], dec["wvw"]
        if not same:
            assert not (rw and rb), "cell starts with a rollback"
            inw = list(rvw)
            dep = rw
            rdz = 1 if (rw == 0 and dep == 0) else 0
            curw = list(wvw) if rw else list(rvw)
        else:
            if rb:
                assert rw == 1
                assert wvw == curw, "rollback pops a mismatched write"
                assert dep >= 1, "rollback with empty write stack"
                dep -= 1
                curw = list(rvw)
            elif rw:
                assert rvw == curw, "write sees a stale value"
                dep += 1
                curw = list(wvw)
            else:
                assert rvw == curw, "read sees a stale value"
                if dep == 0:
                    rdz = 1
        Wd[_D.CURW:_D.CURW + 8, r] = curw
        Wd[_D.INW:_D.INW + 8, r] = inw
        Wd[_D.DEP, r] = dep
        if dep:
            Wd[_D.ZINV, r] = pow(dep, P - 2, P)
        Wd[_D.RDZ, r] = rdz
        # equality gadget
        eqz = []
        for k in range(8):
            dw = (inw[k] - curw[k]) % P
            eqz.append(1 if dw == 0 else 0)
            if dw:
                Wd[_D.EQI + k, r] = pow(dw, P - 2, P)
        Wd[_D.EQZ:_D.EQZ + 8, r] = eqz
        Wd[_D.EQA, r] = int(all(eqz[:4]))
        Wd[_D.EQB, r] = int(all(eqz[4:]))
        Wd[_D.EQ, r] = int(all(eqz))
        prev_cmp = cur_cmp

    # the ZD gadget holds on every dense row: dep 0 -> zd 1 (row 0 and the
    # padding rows included); count and accumulators carry
    Wd[_D.ZD, 0:cap + 1] = (Wd[_D.DEP, 0:cap + 1] == 0)
    Wd[_D.CNT, 0:cap + 1] = int(inst.cnt_in) + np.minimum(
        np.arange(cap + 1), count)
    Wd[_D.ACC:_D.ACC + 4, count + 1:cap + 1] = \
        Wd[_D.ACC:_D.ACC + 4, count:count + 1]

    # emission flags: row rr's cell ends if row rr+1 is a different cell or
    # invalid; emitted (into output slot rr+1) iff (not EQ) or RDZ
    rr = np.arange(1, count + 1)
    next_same = np.zeros(count, dtype=bool)
    next_same[:-1] = Wd[_D.DSEL + NUM_CMP - 1, 2:count + 1] == 1
    emitted = (~next_same) & ((Wd[_D.EQ, rr] == 0) | (Wd[_D.RDZ, rr] == 1))
    Wd[_D.EMIT, rr[emitted] + 1] = 1
    Wd[_D.OCNT, 1:cap + 2] = int(inst.ocnt_in) + np.cumsum(
        Wd[_D.EMIT, 1:cap + 2].astype(np.int64))

    # output encodings for emitted slots (net query of row r-1's cell)
    for r in (rr[emitted] + 1).tolist():
        Wd[_D.OENC:_D.OENC + ENC_W, r] = _net_encoding(
            decs[r - 2], [int(v) for v in Wd[_D.INW:_D.INW + 8, r - 1]],
            [int(v) for v in Wd[_D.CURW:_D.CURW + 8, r - 1]],
            int(Wd[_D.EQ, r - 1]))

    # sponge regions
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    bc = p2c._block_const_rows()
    rg = geo.region
    slots = geo.slots
    regions = ((_D.IENC, _D.V, inst.input_head, _D.TIN_IN, _D.TOUT_IN),
               (_D.SENC, _D.V, inst.sorted_head, _D.TIN_SRT, _D.TOUT_SRT),
               (_D.OENC, _D.EMIT, inst.output_head, _D.TIN_OUT,
                _D.TOUT_OUT))
    for q, (enc_col, act_col, head, tc, oc) in enumerate(regions):
        enc = Wd[enc_col:enc_col + ENC_W, 1:slots + 1].T
        act = Wd[act_col, 1:slots + 1].astype(np.int64)
        cols, tin, tout = nrr.narrow_region_witness(rg, enc, act, head, bc,
                                                    device)
        base = q * nrr.TILE_WIDTH * geo.tiles
        W[base:base + rg.region_width] = cols
        del cols
        Wd[tc:tc + 4, 0:slots + 1] = tin.T
        Wd[oc:oc + 4, 0:slots] = tout.T
    W[D:D + DENSE_WIDTH, :cap + 2] = gl.from_u64(Wd, device)
    return W


def expected_public_inputs(geo: StorageGeometry, inst: StorageInstanceInputs,
                           in_tail: Sequence[int], srt_tail: Sequence[int],
                           out_tail: Sequence[int], acc_out: Sequence[int],
                           cnt_out: int, ocnt_out: int) -> List[int]:
    out = [int(v) % P for v in inst.challenges]
    for head, tail in ((inst.input_head, in_tail),
                       (inst.sorted_head, srt_tail),
                       (inst.output_head, out_tail)):
        out += [int(v) % P for v in head]
        out += [int(v) % P for v in tail]
    out += [int(v) % P for v in inst.acc_in]
    out += [int(v) % P for v in acc_out]
    out += [1, int(inst.cnt_in), int(cnt_out),
            int(inst.ocnt_in), int(ocnt_out)]
    prev = ([int(v) % P for v in inst.prev_enc]
            if inst.prev_enc is not None else [0] * ENC_W)
    out += prev
    return out


def instance_inputs(inst_w, challenges: Sequence[int]
                    ) -> StorageInstanceInputs:
    """Bridge a witness-side StorageCircuitInstance (witness/sorters.py) into
    the circuit payload."""
    return StorageInstanceInputs(
        input_encodings=np.asarray(inst_w.input_encodings, dtype=object),
        sorted_encodings=np.asarray(inst_w.sorted_encodings, dtype=object),
        input_head=tuple(inst_w.input_queue_state[0]),
        sorted_head=tuple(inst_w.sorted_queue_state[0]),
        output_head=tuple(inst_w.output_queue_state[0]),
        challenges=list(challenges),
        acc_in=tuple(inst_w.accumulators_in),
        cnt_in=int(inst_w.num_items_in),
        ocnt_in=int(inst_w.out_items_in),
        prev_enc=inst_w.prev_enc)


def instance_public_inputs(geo: StorageGeometry, inst_w,
                           challenges: Sequence[int]) -> List[int]:
    inst = instance_inputs(inst_w, challenges)
    return expected_public_inputs(
        geo, inst,
        in_tail=inst_w.input_queue_state[1],
        srt_tail=inst_w.sorted_queue_state[1],
        out_tail=inst_w.output_queue_state[1],
        acc_out=inst_w.accumulators_out,
        cnt_out=inst_w.num_items_in + inst_w.num_items,
        ocnt_out=inst_w.out_items_in + inst_w.out_items)
