"""Events / L1-messages sorter circuit: REAL base-layer gate set (types 11/12).

Counterpart of the JAX package's `circuits/events_sorter_circuit.py`; the
port's differences are those of circuits/narrow_region.py (stacked tiles,
copy wiring as cell pairs, the witness on the device) and a dense region
built in numpy with per-element Python only over the valid elements.

Proves, for one instance of the events-sort-dedup argument (reference:
circuit_definitions base_layer events_sort_dedup + the witness decomposer
src/witness/individual_circuits/events_sort_dedup.rs:16):

  1. absorbing this instance's segment of the demuxed INPUT log queue into
     the narrow Poseidon2 queue chain takes the segment head tail to the
     segment end tail (same for the SORTED queue and the OUTPUT queue);
  2. two grand products (2 independent challenge repetitions over the
     20-limb log encodings) agree side-by-side: the sorted stream is a
     permutation of the input stream;
  3. the sorted stream is non-decreasing in timestamp; equal-timestamp
     neighbours are exactly a (forward, rollback) cancellation pair —
     identical in limbs 0..18, rollback flags 0 then 1;
  4. the OUTPUT queue absorbs precisely the surviving events (forwards whose
     rollback does not follow), in order — the dedup_events semantics;
  5. FSM continuation: queue tails, accumulators, item counts, and the
     previous instance's last sorted timestamp are public inputs, so a chain
     of instances covers an unbounded event log.

Layout: three narrow sponge regions (circuits/narrow_region.py) of
`tiles` tiles each — input, sorted, output — plus a dense region with one
row per element (row r = element r-1). The output region's slot s absorbs
element s-1's encoding one row late (the emission of element j is decidable
only once element j+1 is visible), staged through OENC columns; slot 0 is
structurally dead (EMIT[1] = 0). An instance never starts with the rollback
half of a pair (s_first * V * ET = 0) — the witness decomposer's safe-split
respects this, and it makes per-instance emission decisions sound.

Timestamp extraction: limb 16 of the log encoding is
ts | b16<<32 | b17<<40 | b18<<48 (witness/encodings.py encode_log_query);
the circuit decomposes it as TS + HB*2^32.. with byte lookups on TS's 4
bytes and the 3 high bytes, so TS < 2^32 and the strict-increase check
(TS' - TS - 1 = 4 bytes) is injective mod p.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import T
from ..prover import plonkish as pk
from . import narrow_region as nrr
from . import poseidon2_circuit as p2c

P = gl.P
NUM_REPETITIONS = 2
ENC_W = nrr.ENC_WIDTH                      # 20
NUM_CHALLENGES = NUM_REPETITIONS * (ENC_W + 1)  # 42


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
    TS = 110
    TB = 111       # 4 ts bytes
    HB = 115       # 3 high bytes of limb 16
    ET = 118
    DB = 119       # 4 bytes of ts diff minus 1
    TIN_IN = 123
    TOUT_IN = 127
    TIN_SRT = 131
    TOUT_SRT = 135
    TIN_OUT = 139
    TOUT_OUT = 143


DENSE_WIDTH = 147

# const columns
C_RC = 0
C_SLIN, C_SEXT, C_SINT = T, T + 1, T + 2
C_CE, C_EE = T + 3, T + 4
C_SD, C_SE, C_ST, C_SQ = T + 5, T + 6, T + 7, T + 8
C_SFIRST, C_SVEND = T + 9, T + 10
NUM_CONST = T + 11


@dataclasses.dataclass(frozen=True)
class EventsGeometry:
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


def events_ir(log_n: int, tiles: int = 1) -> pk.PlonkishIR:
    geo = EventsGeometry(log_n, tiles)
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

        s_d, s_e, s_t, s_q = c[C_SD], c[C_SE], c[C_ST], c[C_SQ]
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
        emit, emit_n = w[D + _D.EMIT], w_next[D + _D.EMIT]
        ts, ts_n = w[D + _D.TS], w_next[D + _D.TS]
        et, et_n = w[D + _D.ET], w_next[D + _D.ET]

        # challenges constant; validity boolean+monotone; count
        for j in range(NUM_CHALLENGES):
            out.append(alg.mul(s_d, alg.sub(ch_next[j], ch[j])))
        out.append(alg.mul(s_d, alg.sub(alg.mul(v_n, v_n), v_n)))
        out.append(alg.mul(s_d, alg.mul(v_n, _one_minus(alg, v))))
        out.append(alg.mul(s_d, alg.sub(cnt_n, alg.add(cnt, v_n))))

        # grand products: acc' = acc * (v'*term' + 1 - v')
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

        # timestamp extraction (valid rows): limb16 = TS + HB*2^32..,
        # TS = 4 bytes
        hb = [w[D + _D.HB + k] for k in range(3)]
        tb = [w[D + _D.TB + k] for k in range(4)]
        packed = ts
        for k in range(3):
            packed = alg.add(packed, alg.mul_int(hb[k], 1 << (32 + 8 * k)))
        out.append(alg.mul(alg.mul(s_q, v), alg.sub(senc[16], packed)))
        tsum = tb[0]
        for k in range(1, 4):
            tsum = alg.add(tsum, alg.mul_int(tb[k], 1 << (8 * k)))
        out.append(alg.mul(alg.mul(s_q, v), alg.sub(ts, tsum)))
        # rollback flag boolean
        rb = senc[19]
        out.append(alg.mul(alg.mul(s_q, v), alg.sub(alg.mul(rb, rb), rb)))

        # sorted adjacency (pair r,r+1 = elements r-1,r)
        sdv = alg.mul(s_d, v_n)
        out.append(alg.mul(s_d, alg.sub(alg.mul(et_n, et_n), et_n)))
        out.append(alg.mul(sdv, alg.mul(et_n, alg.sub(ts_n, ts))))
        db_n = [w_next[D + _D.DB + k] for k in range(4)]
        dbsum = db_n[0]
        for k in range(1, 4):
            dbsum = alg.add(dbsum, alg.mul_int(db_n[k], 1 << (8 * k)))
        diff = alg.sub(ts_n, ts)
        out.append(alg.mul(sdv, alg.mul(_one_minus(alg, et_n),
                                        alg.sub(diff, alg.add_int(dbsum, 1)))))
        # cancellation pair: forward then rollback, limbs 0..18 equal
        pair = alg.mul(sdv, et_n)
        out.append(alg.mul(pair, senc[19]))
        out.append(alg.mul(pair, alg.add_int(senc_n[19], P - 1)))
        for j in range(ENC_W - 1):
            out.append(alg.mul(pair, alg.sub(senc_n[j], senc[j])))

        # emission: EMIT[r+1] = V[r]*(1-RB[r])*(1-ET[r+1]*V[r+1])
        rule = alg.mul(alg.mul(v, _one_minus(alg, rb)),
                       _one_minus(alg, alg.mul(et_n, v_n)))
        out.append(alg.mul(s_e, alg.sub(emit_n, rule)))
        # staged output encodings: emitted slot r absorbs element r-1's enc
        for j in range(ENC_W):
            out.append(alg.mul(alg.mul(s_e, emit_n),
                               alg.sub(oenc_n[j], senc[j])))

        # boundary rows
        out.append(alg.mul(s_first, alg.mul(v, et)))  # no split pairs
        out.append(alg.mul(s_first, emit))            # slot 0 dead
        out.append(alg.mul(s_vend, v))                # slot cap inactive

        # output count + tail registers (pairs 0..cap)
        out.append(alg.mul(s_t, alg.sub(ocnt_n, alg.add(ocnt, emit_n))))
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
                     + NUM_CHALLENGES + 3 + 4 + 3 + 3
                     + 2 + (ENC_W - 1) + 1 + ENC_W + 3 + 1 + 12)

    pis: List[Tuple[int, int]] = []
    D_ = geo.dense_base
    pis += [(D_ + _D.CH + j, 0) for j in range(NUM_CHALLENGES)]
    for tin_c in (_D.TIN_IN, _D.TIN_SRT, _D.TIN_OUT):
        pis += [(D_ + tin_c + k, 0) for k in range(4)]
        pis += [(D_ + tin_c + k, cap + 1) for k in range(4)]
    pis += [(D_ + _D.ACC + k, 0) for k in range(4)]
    pis += [(D_ + _D.ACC + k, cap) for k in range(4)]
    pis += [(D_ + _D.V, 0), (D_ + _D.CNT, 0), (D_ + _D.CNT, cap),
            (D_ + _D.OCNT, 0), (D_ + _D.OCNT, cap + 1), (D_ + _D.TS, 0)]

    byte_table = np.arange(256, dtype=object).reshape(256, 1)
    lookup_cols = ([D_ + _D.TB + k for k in range(4)]
                   + [D_ + _D.HB + k for k in range(3)]
                   + [D_ + _D.DB + k for k in range(4)])
    lookup_sets = tuple((0, (col,)) for col in lookup_cols)

    return pk.PlonkishIR(
        log_n=log_n, num_witness=geo.num_witness, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(byte_table,), lookup_sets=lookup_sets)


def _const_rows(geo: EventsGeometry) -> np.ndarray:
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
    rows[1, C_SFIRST] = 1
    rows[cap + 1, C_SVEND] = 1
    return rows


def _copy_pairs(geo: EventsGeometry) -> Tuple[np.ndarray, np.ndarray]:
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


def events_setup(ir: pk.PlonkishIR, geo: EventsGeometry,
                 cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    wiring = pk.wire_copy_pairs(geo.n, *_copy_pairs(geo))
    return pk.build_setup(ir, _const_rows(geo).T, wiring, cfg, device=device)


@dataclasses.dataclass
class EventsInstanceInputs:
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
    prev_ts: int                  # last sorted element's ts of prev instance
    last_in_chain: bool           # completion: last element emits if forward


def _ts_of(enc: Sequence[int]) -> int:
    return int(enc[16]) & 0xFFFFFFFF


def events_witness(ir: pk.PlonkishIR, geo: EventsGeometry,
                   inst: EventsInstanceInputs, device=None) -> gl.GF:
    """The witness (num_witness, n) on `device` (`None` means the CUDA
    card): the dense region's rows 0..cap+1 in numpy, the three sponge
    regions by `narrow_region_witness`."""
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
    Wd[_D.CNT, 0] = int(inst.cnt_in)
    Wd[_D.OCNT, 0] = int(inst.ocnt_in)
    Wd[_D.TS, 0] = int(inst.prev_ts)
    acc = [int(a) % P for a in inst.acc_in]
    Wd[_D.ACC:_D.ACC + 4, 0] = acc

    prev_ts = int(inst.prev_ts)
    rb_list = [0]
    et_list = [0]
    for i in range(count):
        r = i + 1
        ie = [int(v) for v in inst.input_encodings[i]]
        se = [int(v) for v in inst.sorted_encodings[i]]
        Wd[_D.IENC:_D.IENC + ENC_W, r] = ie
        Wd[_D.SENC:_D.SENC + ENC_W, r] = se
        Wd[_D.V, r] = 1
        Wd[_D.CNT, r] = int(inst.cnt_in) + r
        for rep in range(NUM_REPETITIONS):
            base = rep * (ENC_W + 1)
            ti = (ch[base + ENC_W] + sum(ch[base + j] * ie[j]
                                         for j in range(ENC_W))) % P
            ts_ = (ch[base + ENC_W] + sum(ch[base + j] * se[j]
                                          for j in range(ENC_W))) % P
            acc[2 * rep] = acc[2 * rep] * ti % P
            acc[2 * rep + 1] = acc[2 * rep + 1] * ts_ % P
        Wd[_D.ACC:_D.ACC + 4, r] = acc
        ts = _ts_of(se)
        Wd[_D.TS, r] = ts
        for k in range(4):
            Wd[_D.TB + k, r] = (ts >> (8 * k)) & 0xFF
        for k in range(3):
            Wd[_D.HB + k, r] = (se[16] >> (32 + 8 * k)) & 0xFF
        rb = se[19] & 1
        assert se[19] in (0, 1), "rollback limb must be boolean"
        et = 1 if ts == prev_ts else 0
        if i == 0:
            assert et == 0, "instance must not begin inside a cancel pair"
        Wd[_D.ET, r] = et
        if et:
            assert rb == 1 and rb_list[-1] == 0, "cancel pair must be fw,rb"
            assert all(se[j] == int(Wd[_D.SENC + j, r - 1])
                       for j in range(ENC_W - 1)), "cancel pair limbs differ"
        else:
            d = ts - prev_ts
            assert 1 <= d < (1 << 32) + 1, "sorted stream out of ts order"
            for k in range(4):
                Wd[_D.DB + k, r] = ((d - 1) >> (8 * k)) & 0xFF
        prev_ts = ts
        rb_list.append(rb)
        et_list.append(et)

    # carry CNT/ACC through padding rows
    Wd[_D.CNT, count + 1:cap + 1] = Wd[_D.CNT, count]
    Wd[_D.ACC:_D.ACC + 4, count + 1:cap + 1] = \
        Wd[_D.ACC:_D.ACC + 4, count:count + 1]

    # emission flags (rows 2..cap+1): element r-2 emits iff forward and not
    # cancelled by element r-1
    for j in range(count):
        next_valid = (j + 1) < count
        et_next = et_list[j + 2] if next_valid else 0
        Wd[_D.EMIT, j + 2] = (1 - rb_list[j + 1]) * (1 - et_next)
    emits = Wd[_D.EMIT].astype(np.int64)
    Wd[_D.OCNT, 1:cap + 2] = (int(inst.ocnt_in)
                              + np.cumsum(emits[1:cap + 2])).astype(np.uint64)
    er = np.flatnonzero(emits[2:cap + 2]) + 2
    Wd[_D.OENC:_D.OENC + ENC_W, er] = Wd[_D.SENC:_D.SENC + ENC_W, er - 1]

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


def expected_public_inputs(geo: EventsGeometry, inst: EventsInstanceInputs,
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
            int(inst.ocnt_in), int(ocnt_out), int(inst.prev_ts)]
    return out


def instance_inputs(inst_w, challenges: Sequence[int]) -> EventsInstanceInputs:
    """Bridge a witness-side EventsCircuitInstance (witness/sorters.py) into
    the circuit payload."""
    return EventsInstanceInputs(
        input_encodings=np.asarray(inst_w.input_encodings, dtype=object),
        sorted_encodings=np.asarray(inst_w.sorted_encodings, dtype=object),
        input_head=tuple(inst_w.input_queue_state[0]),
        sorted_head=tuple(inst_w.sorted_queue_state[0]),
        output_head=tuple(inst_w.output_queue_state[0]),
        challenges=list(challenges),
        acc_in=tuple(inst_w.accumulators_in),
        cnt_in=int(inst_w.num_items_in),
        ocnt_in=int(inst_w.out_items_in),
        prev_ts=int(inst_w.prev_ts),
        last_in_chain=bool(inst_w.completion_flag))


def instance_public_inputs(geo: EventsGeometry, inst_w,
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
