"""Log-demuxer circuit: REAL base-layer gate set (type 4).

Proves, for one instance of the demux argument (reference:
circuit_definitions base_layer log_demux + the witness decomposer
src/witness/individual_circuits/log_demux.rs:20):

  1. absorbing this instance's segment of the rollback-resolved log queue
     takes the input head tail to the end tail (narrow Poseidon2 chain);
  2. every element is routed into EXACTLY ONE of six output queues, with
     the class derived in-circuit from the element's own encoding: the aux
     byte (limb 17 bits 40..47) selects storage/events/L1/precompile, and
     precompiles split by the FULL 160-bit address — equality to the
     keccak/sha256 addresses (with all high address bytes forced to zero)
     or provable disequality (provided-inverse cells) for ecrecover;
  3. each output queue absorbs exactly its elements, in order — the narrow
     regions' subset absorption (non-monotone bv) with per-queue tail
     registers;
  4. FSM continuation: all seven queue tails and per-class item counts are
     public inputs, chaining unbounded log segments across instances.

Byte soundness: limbs 10..17 are fully decomposed (7 bytes each, byte
lookups), so the address/aux extraction is injective — the limb value is
pinned as word + high-byte packing with every byte < 256.

Layout: seven narrow sponge regions (circuits/narrow_region.py) sharing the
SAME staged encoding cells (copy cycles merge across regions), plus a dense
region with one row per element.

The port's differences are those of circuits/narrow_region.py (stacked
tiles, copy wiring as cell pairs, the witness on the device): the seven
regions' pairs share their staged encoding cells, which
`plonkish.wire_copy_pairs` merges exactly as the sequential cycle merge
does; the dense region is built in numpy over whole columns.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.poseidon2_params import T
from ..prover import plonkish as pk
from ..witness.log_demux import NUM_CLASSES
from . import narrow_region as nrr
from . import poseidon2_circuit as p2c

P = gl.P
ENC_W = nrr.ENC_WIDTH            # 20
NUM_QUEUES = 1 + NUM_CLASSES     # input + 6
KECCAK_ADDR = 0x8010
SHA256_ADDR = 0x8002

# byte decomposition of limbs 10..17: 7 bytes each
_DECOMP_LIMBS = list(range(10, 18))
_SHIFTS = (0, 8, 16, 24, 32, 40, 48)
NUM_BYTES = 7 * len(_DECOMP_LIMBS)  # 56


def _by_idx(limb: int, b: int) -> int:
    return 7 * (limb - 10) + b


# address bytes 0..19 as BY offsets
_AB = ([_by_idx(10, 6)]
       + [_by_idx(11 + i, 4 + j) for i in range(5) for j in range(3)]
       + [_by_idx(16, 4 + j) for j in range(3)]
       + [_by_idx(17, 4)])
_AUX = _by_idx(17, 5)


class _D:
    IENC = 0
    BY = 20
    B0 = 76
    B1 = 77
    SEL = 78       # 6 class selectors
    I1 = 84
    I2 = 85
    V = 86
    CNT = 87       # input + 6 class counts
    TIN = 94       # 7 queues x 4
    TOUT = 122


DENSE_WIDTH = 150

C_RC = 0
C_SLIN, C_SEXT, C_SINT = T, T + 1, T + 2
C_CE, C_EE = T + 3, T + 4
C_SD, C_SQ = T + 5, T + 6
NUM_CONST = T + 7


@dataclasses.dataclass(frozen=True)
class DemuxGeometry:
    log_n: int
    tiles: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def region(self) -> nrr.NarrowGeometry:
        return nrr.NarrowGeometry(self.log_n, self.tiles)

    @property
    def capacity(self) -> int:
        return self.region.capacity

    @property
    def dense_base(self) -> int:
        return NUM_QUEUES * nrr.TILE_WIDTH * self.tiles

    @property
    def num_witness(self) -> int:
        return self.dense_base + DENSE_WIDTH


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


N_DENSE_GATES = 8 + 3 + 3 + 1 + 3 + 2 + 2 + 18 + 2 + 7 + 28


def demux_ir(log_n: int, tiles: int = 1) -> pk.PlonkishIR:
    geo = DemuxGeometry(log_n, tiles)
    n, cap = geo.n, geo.capacity
    assert cap + 1 <= n and n >= 256
    D = geo.dense_base
    rg = geo.region

    def eval_gates(alg, w, w_next, c):
        out = []
        for q in range(NUM_QUEUES):
            out += nrr.narrow_region_gates(
                alg, w, w_next, c, q * nrr.TILE_WIDTH * tiles, rg,
                C_RC, C_SLIN, C_SEXT, C_SINT, C_CE, C_EE)

        s_d, s_q = c[C_SD], c[C_SQ]
        by = [w[D + _D.BY + j] for j in range(NUM_BYTES)]
        v, v_n = w[D + _D.V], w_next[D + _D.V]
        b0, b1 = w[D + _D.B0], w[D + _D.B1]
        sel = [w[D + _D.SEL + k] for k in range(NUM_CLASSES)]
        sel_n = [w_next[D + _D.SEL + k] for k in range(NUM_CLASSES)]

        # limb reconstruction from bytes
        for li, limb in enumerate(_DECOMP_LIMBS):
            acc = None
            for b in range(7):
                term = alg.mul_int(by[_by_idx(limb, b)], 1 << _SHIFTS[b])
                acc = term if acc is None else alg.add(acc, term)
            out.append(alg.mul(s_q, alg.sub(w[D + _D.IENC + limb], acc)))

        # aux byte = b0 + 2 b1, bits boolean
        out.append(alg.mul(s_q, alg.sub(alg.mul(b0, b0), b0)))
        out.append(alg.mul(s_q, alg.sub(alg.mul(b1, b1), b1)))
        out.append(alg.mul(s_q, alg.sub(by[_AUX],
                                        alg.add(b0, alg.mul_int(b1, 2)))))

        # class selectors from (V, aux bits)
        nb0, nb1 = _one_minus(alg, b0), _one_minus(alg, b1)
        out.append(alg.mul(s_q, alg.sub(sel[0],
                                        alg.mul(v, alg.mul(nb0, nb1)))))
        out.append(alg.mul(s_q, alg.sub(sel[1],
                                        alg.mul(v, alg.mul(b0, nb1)))))
        out.append(alg.mul(s_q, alg.sub(sel[2],
                                        alg.mul(v, alg.mul(nb0, b1)))))
        pre = alg.mul(v, alg.mul(b0, b1))
        out.append(alg.mul(s_q, alg.sub(
            alg.add(alg.add(sel[3], sel[4]), sel[5]), pre)))
        for k in (3, 4, 5):
            out.append(alg.mul(s_q, alg.sub(alg.mul(sel[k], sel[k]), sel[k])))

        # precompile address split (full-width address)
        addr16 = alg.add(by[_AB[0]], alg.mul_int(by[_AB[1]], 256))
        out.append(alg.mul(s_q, alg.mul(sel[3],
                                        alg.add_int(addr16, P - KECCAK_ADDR))))
        out.append(alg.mul(s_q, alg.mul(sel[4],
                                        alg.add_int(addr16, P - SHA256_ADDR))))
        i1, i2 = w[D + _D.I1], w[D + _D.I2]
        t1 = alg.add_int(addr16, P - KECCAK_ADDR)
        t2 = alg.add_int(addr16, P - SHA256_ADDR)
        out.append(alg.mul(s_q, alg.mul(sel[5],
                                        alg.add_int(alg.mul(t1, i1), P - 1))))
        out.append(alg.mul(s_q, alg.mul(sel[5],
                                        alg.add_int(alg.mul(t2, i2), P - 1))))
        ks = alg.add(sel[3], sel[4])
        for j in range(2, 20):
            out.append(alg.mul(s_q, alg.mul(ks, by[_AB[j]])))

        # validity flag boolean + monotone
        out.append(alg.mul(s_d, alg.sub(alg.mul(v_n, v_n), v_n)))
        out.append(alg.mul(s_d, alg.mul(v_n, _one_minus(alg, v))))

        # counts (input + per class)
        out.append(alg.mul(s_d, alg.sub(w_next[D + _D.CNT],
                                        alg.add(w[D + _D.CNT], v_n))))
        for k in range(NUM_CLASSES):
            out.append(alg.mul(s_d, alg.sub(
                w_next[D + _D.CNT + 1 + k],
                alg.add(w[D + _D.CNT + 1 + k], sel_n[k]))))

        # tail registers per queue (act = V for input, SEL_k for outputs)
        for q in range(NUM_QUEUES):
            act_n = v_n if q == 0 else sel_n[q - 1]
            for k in range(4):
                tin = w[D + _D.TIN + 4 * q + k]
                tin_nx = w_next[D + _D.TIN + 4 * q + k]
                tout = w[D + _D.TOUT + 4 * q + k]
                mux = alg.add(alg.mul(act_n, tout),
                              alg.mul(_one_minus(alg, act_n), tin))
                out.append(alg.mul(s_d, alg.sub(tin_nx, mux)))
        return out

    n_constraints = NUM_QUEUES * tiles * nrr.NUM_GATES_PER_TILE + N_DENSE_GATES

    D_ = geo.dense_base
    pis: List[Tuple[int, int]] = []
    for q in range(NUM_QUEUES):
        pis += [(D_ + _D.TIN + 4 * q + k, 0) for k in range(4)]
        pis += [(D_ + _D.TIN + 4 * q + k, cap) for k in range(4)]
    pis += [(D_ + _D.V, 0)]
    pis += [(D_ + _D.CNT + j, 0) for j in range(1 + NUM_CLASSES)]
    pis += [(D_ + _D.CNT + j, cap) for j in range(1 + NUM_CLASSES)]

    byte_table = np.arange(256, dtype=object).reshape(256, 1)
    lookup_sets = tuple((0, (D_ + _D.BY + j,)) for j in range(NUM_BYTES))

    return pk.PlonkishIR(
        log_n=log_n, num_witness=geo.num_witness, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis),
        lookup_tables=(byte_table,), lookup_sets=lookup_sets)


def _const_rows(geo: DemuxGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n, cap = geo.n, geo.capacity
    rows = np.zeros((n, NUM_CONST), dtype=np.uint64)
    block = p2c._block_const_rows().astype(np.uint64)
    rows[:, :T + 3] = np.tile(block, (n // nrr.ROWS_PER_PERMUTATION, 1))
    rows[:, T + 3:T + 5] = nrr.narrow_cadence_const(geo.region)
    rows[0:cap, C_SD] = 1
    rows[1:cap + 1, C_SQ] = 1
    return rows


def _copy_pairs(geo: DemuxGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """The setup's copy cycles as ordered cell pairs, queue by queue; every
    queue's region links to the same staged encoding cells."""
    D = geo.dense_base
    rg = geo.region
    pairs = []
    for q in range(NUM_QUEUES):
        bv_col = _D.V if q == 0 else _D.SEL + (q - 1)
        pairs.append(nrr.narrow_region_copy_cycles(
            q * nrr.TILE_WIDTH * geo.tiles, rg, geo.capacity,
            enc_cell=lambda s, j: (D + _D.IENC + j, s + 1),
            bv_cell=lambda s, bc=bv_col: (D + bc, s + 1),
            tin_cell=lambda s, k, qq=q: (D + _D.TIN + 4 * qq + k, s),
            tout_cell=lambda s, k, qq=q: (D + _D.TOUT + 4 * qq + k, s)))
    return (np.concatenate([a for a, _ in pairs]),
            np.concatenate([b for _, b in pairs]))


def demux_setup(ir: pk.PlonkishIR, geo: DemuxGeometry,
                cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    wiring = pk.wire_copy_pairs(geo.n, *_copy_pairs(geo))
    return pk.build_setup(ir, _const_rows(geo).T, wiring, cfg, device=device)


def demux_witness(ir: pk.PlonkishIR, geo: DemuxGeometry, inst,
                  device=None) -> gl.GF:
    """Columns from a DemuxCircuitInstance (witness/log_demux.py), on
    `device` (`None` means the CUDA card). The dense region is column
    arithmetic over the valid rows; the seven sponge regions come from
    `narrow_region_witness`."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = inst.encodings.shape[0]
    assert count <= cap
    D = geo.dense_base
    Wd = np.zeros((DENSE_WIDTH, cap + 1), dtype=np.uint64)
    Wd[_D.V, 0:count + 1] = 1
    enc = np.asarray(inst.encodings, dtype=object).astype(
        np.uint64).reshape(-1, ENC_W)
    cls = np.asarray(inst.classes, dtype=np.int64).reshape(-1)
    r = np.arange(1, count + 1)
    Wd[_D.IENC:_D.IENC + ENC_W, 1:count + 1] = enc.T
    for limb in _DECOMP_LIMBS:
        for b in range(7):
            Wd[_D.BY + _by_idx(limb, b), 1:count + 1] = \
                (enc[:, limb] >> np.uint64(_SHIFTS[b])) & np.uint64(0xFF)
    aux = (enc[:, 17] >> np.uint64(40)) & np.uint64(0xFF)
    Wd[_D.B0, 1:count + 1] = aux & np.uint64(1)
    Wd[_D.B1, 1:count + 1] = (aux >> np.uint64(1)) & np.uint64(1)
    Wd[_D.SEL + cls, r] = 1
    for i in np.flatnonzero(cls == 5).tolist():
        e = enc[i]
        addr16 = (int(e[10]) >> 48 & 0xFF) + 256 * (int(e[11]) >> 32 & 0xFF)
        Wd[_D.I1, i + 1] = pow((addr16 - KECCAK_ADDR) % P, P - 2, P)
        Wd[_D.I2, i + 1] = pow((addr16 - SHA256_ADDR) % P, P - 2, P)
    # counts: input and per class, carried through the padding rows
    onehot = np.zeros((cap + 1, NUM_CLASSES), dtype=np.int64)
    onehot[r, cls] = 1
    Wd[_D.CNT, 0:cap + 1] = int(inst.num_items_in) + np.minimum(
        np.arange(cap + 1), count)
    Wd[_D.CNT + 1:_D.CNT + 1 + NUM_CLASSES, 0:cap + 1] = (
        np.array([int(v) for v in inst.out_items_in], dtype=np.int64)
        + np.cumsum(onehot, axis=0)).T

    # sponge regions (shared staged encodings)
    active = np.zeros((NUM_QUEUES, cap), dtype=np.int64)
    active[0, :count] = 1
    active[1 + cls, r - 1] = 1
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    bc = p2c._block_const_rows()
    rg = geo.region
    enc_all = Wd[_D.IENC:_D.IENC + ENC_W, 1:cap + 1].T
    heads = [inst.input_queue_state[0]] + \
        [inst.output_queue_states[k][0] for k in range(NUM_CLASSES)]
    for q in range(NUM_QUEUES):
        cols, tin, tout = nrr.narrow_region_witness(
            rg, enc_all, active[q], heads[q], bc, device)
        base = q * nrr.TILE_WIDTH * geo.tiles
        W[base:base + rg.region_width] = cols
        del cols
        Wd[_D.TIN + 4 * q:_D.TIN + 4 * q + 4, 0:cap + 1] = tin.T
        Wd[_D.TOUT + 4 * q:_D.TOUT + 4 * q + 4, 0:cap] = tout.T
    W[D:D + DENSE_WIDTH, :cap + 1] = gl.from_u64(Wd, device)
    return W


def instance_public_inputs(geo: DemuxGeometry, inst) -> List[int]:
    out: List[int] = []
    states = [inst.input_queue_state] + list(inst.output_queue_states)
    for head, tail, _cnt in states:
        out += [int(v) % P for v in head]
        out += [int(v) % P for v in tail]
    out += [1]
    out += [int(inst.num_items_in)] + [int(v) for v in inst.out_items_in]
    out += [int(inst.num_items_in + inst.num_items)]
    out += [int(i + o) for i, o in zip(inst.out_items_in, inst.out_items)]
    return out
