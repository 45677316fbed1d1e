"""Code-decommitter circuit (type 3): an in-circuit sha256 of the bytecode.

The reference circuit (circuit_definitions base_layer CodeDecommitter +
src/witness/individual_circuits/decommit_code.rs:20) pops fresh decommit
requests, streams the bytecode words into the code page (memory-queue
writes), and proves the versioned code hash: byte0=0x01, bytes2..3 = word
count, bytes4..31 = sha256(bytecode)[4:32]. This module proves the HASH —
the hot compute — as a fully chained in-circuit sha256 over the streamed
words (one proof per fresh bytecode):

  - the sha256 round core (circuits/sha256_circuit.py layout: 66 rows per
    compression, bit-state + schedule shift register + exact carry-split
    word additions);
  - compressions are CHAINED by constraint: the working state entering
    block k+1 equals block k's digest (feed-forward included), and block
    0's state is pinned to the FIPS IV — so the digest accumulator at the
    last row is sha256 of the whole stream by construction;
  - the absorbed block words are bound by the two-rep fingerprint
    accumulator (challenge-after-commit);
  - DIGA: 8 digest-limb accumulators updated at valid output rows expose
    the final digest in the public inputs; the oracle cross-checks
    digest[4:32] against the request's versioned hash and word count
    (witness/decommitter.py bytecode_hash).

Counterpart of the JAX package's `circuits/decommitter_circuit.py`. It takes
its round core from the port's `sha256_circuit` (`sha256_core_gates`, the
same constraint list the JAX package repeats here), stacked on the device
algebra as there; the witness is built as bit planes vectorised over
compressions, every unused slot the dummy compression of the zero state and
block.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from .keccak_circuit import (challenge_power_gates, challenge_powers,
                             col_stack, dot_powers, place_rows, rows_of,
                             slot_sources, stacks, validity_count_gates)
from .sha256_circuit import (NUM_ROUNDS, ROWS_PER_INVOCATION,
                             _one_minus, compression_trace, place_round_core,
                             round_const_rows, sha256_core_gates,
                             sha256_round_trace, stacked_traces)
from .sha256_circuit import _C as _ShaC

P = gl.P
NUM_REPS = 2
BLK_LIMBS = 16                     # u32 words per 64-byte block
_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


class _C:
    """Column offsets (sha256 core layout + hasher accumulators)."""
    S = 0                               # 8 x 32 state bits (a..h)
    W = 256                             # 16 x 32 schedule shift register
    HIN = W + 512                       # 8 carried input words
    D = HIN + 8                         # 8 digest words
    CE = D + 8                          # 3 e_new carry bits
    CA = CE + 3                         # 3 a_new carry bits
    CW = CA + 3                         # 2 schedule carry bits
    CD = CW + 2                         # 8 digest carry bits
    DIGA = CD + 8                       # 8 digest accumulators
    PCH = DIGA + 8                      # 2 reps x 16 challenge powers
    GAMMA = PCH + NUM_REPS * BLK_LIMBS
    ACC = GAMMA + NUM_REPS
    V = ACC + NUM_REPS
    CNT = V + 1


assert (_C.S, _C.W, _C.HIN, _C.D, _C.CE, _C.CD) == \
    (_ShaC.S, _ShaC.W, _ShaC.HIN, _ShaC.D, _ShaC.CE, _ShaC.CD)
NUM_WITNESS = _C.CNT + 1

# const columns: s_round, s_sched, s_absorb, s_out, s_carry, s_bend,
# s_chain (row 65 of non-final invocations), s_first (row 0), s_dcar
# (digest-accumulator carry rows), s_wrap, K round constant
(K_SR, K_SS2, K_SA, K_SO, K_SC, K_SB, K_SH, K_SF, K_SD, K_SW,
 K_K) = range(11)
NUM_CONST = 11


@dataclasses.dataclass(frozen=True)
class DecommitterGeometry:
    log_n: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def capacity(self) -> int:
        """sha256 compressions per instance."""
        return self.n // ROWS_PER_INVOCATION


def _digest_gates_stacked(alg, w, w_next, Sw, Sw_n, v, v_n, s_o, s_h, s_f,
                          s_d) -> List:
    D = col_stack(w, _C.D, 8)
    dga = col_stack(w, _C.DIGA, 8)
    dga_n = col_stack(w_next, _C.DIGA, 8)
    out = []
    # digest at the output row, and carried one row so the chain row sees it
    digest = alg.mul(s_o, alg.sub(
        alg.add(D, alg.mul_int(col_stack(w, _C.CD, 8), 1 << 32)),
        alg.add(col_stack(w, _C.HIN, 8), Sw)))
    carry = alg.mul(s_o, alg.sub(col_stack(w_next, _C.D, 8), D))
    out += rows_of(torch.stack([digest, carry], dim=1))
    # CHAINING: the next compression continues from this digest
    out += rows_of(alg.mul(alg.mul(s_h, v_n), alg.sub(Sw_n, D)))
    # block 0 starts from the FIPS IV
    iv = gl.from_int([P - x for x in _IV], D.device).reshape(8, 1)
    out += rows_of(alg.mul(s_f, alg.add(Sw, iv)))
    # digest accumulators: capture D while valid, carry elsewhere
    upd = alg.mul(s_o, alg.sub(dga_n, alg.add(
        alg.mul(v, D), alg.mul(_one_minus(alg, v), dga))))
    keep = alg.mul(s_d, alg.sub(dga_n, dga))
    out += rows_of(torch.stack([upd, keep], dim=1))
    return out


def _digest_gates_host(alg, w, w_next, Sw, Sw_n, v, v_n, s_o, s_h, s_f,
                       s_d) -> List:
    """The same values as the JAX package's loops form them (its algebra
    calls in its order; `Sw`, `Sw_n` form each word where it is read)."""
    out = []
    for j in range(8):
        out.append(alg.mul(s_o, alg.sub(
            alg.add(w[_C.D + j], alg.mul_int(w[_C.CD + j], 1 << 32)),
            alg.add(w[_C.HIN + j], Sw[j]))))
        out.append(alg.mul(s_o, alg.sub(w_next[_C.D + j], w[_C.D + j])))
    for j in range(8):
        out.append(alg.mul(alg.mul(s_h, v_n), alg.sub(Sw_n[j], w[_C.D + j])))
    for j in range(8):
        out.append(alg.mul(s_f, alg.add_int(Sw[j], P - _IV[j])))
    for j in range(8):
        dga, dga_n = w[_C.DIGA + j], w_next[_C.DIGA + j]
        upd = alg.add(alg.mul(v, w[_C.D + j]),
                      alg.mul(_one_minus(alg, v), dga))
        out.append(alg.mul(s_o, alg.sub(dga_n, upd)))
        out.append(alg.mul(s_d, alg.sub(dga_n, dga)))
    return out


def decommitter_ir(log_n: int) -> pk.PlonkishIR:
    geo = DecommitterGeometry(log_n)
    n = geo.n
    assert geo.capacity >= 1

    def eval_gates(alg, w, w_next, c):
        s_r, s_s2, s_a = c[K_SR], c[K_SS2], c[K_SA]
        s_o, s_c, s_b = c[K_SO], c[K_SC], c[K_SB]
        s_h, s_f, s_d, s_w, k_rc = c[K_SH], c[K_SF], c[K_SD], c[K_SW], c[K_K]
        out, Sw, Ww, Sw_n = sha256_core_gates(alg, w, w_next, s_r, s_s2,
                                              s_a, k_rc)
        v, v_n = w[_C.V], w_next[_C.V]
        # the digest (defined, carried), the chaining, the IV, the digest
        # accumulators
        digest_gates = (_digest_gates_stacked if stacks(alg)
                        else _digest_gates_host)
        out += digest_gates(alg, w, w_next, Sw, Sw_n, v, v_n, s_o, s_h, s_f,
                            s_d)

        # validity / count chains
        out += validity_count_gates(alg, v, v_n, w[_C.CNT], w_next[_C.CNT],
                                    s_b, s_w, s_a, s_c)

        # block-word fingerprints (update at absorb rows)
        for rep in range(NUM_REPS):
            pbase = _C.PCH + rep * BLK_LIMBS
            gamma = w[_C.GAMMA + rep]
            acc, acc_n = w[_C.ACC + rep], w_next[_C.ACC + rep]
            out += challenge_power_gates(alg, w, w_next, pbase, BLK_LIMBS,
                                         _C.GAMMA + rep, s_a)
            t = alg.add(gamma, dot_powers(alg, w, pbase, Ww))
            gated = alg.add(alg.mul(v, t), _one_minus(alg, v))
            out.append(alg.mul(s_a, alg.sub(acc_n, alg.mul(acc, gated))))
            out.append(alg.mul(s_c, alg.sub(acc_n, acc)))
        return out

    n_constraints = (256 + 512 + 16                  # booleanity
                     + 480 + 1                       # schedule
                     + 2 + 6                         # round
                     + 16 + 16                       # h_in + digest(def+carry)
                     + 8 + 8                         # chain + IV
                     + 16                            # digest accumulators
                     + 5                             # v/cnt
                     + NUM_REPS * (1 + BLK_LIMBS
                                   + BLK_LIMBS - 1 + 2))

    pis: List[Tuple[int, int]] = []
    for rep in range(NUM_REPS):
        pis.append((_C.PCH + rep * BLK_LIMBS, 0))
        pis.append((_C.GAMMA + rep, 0))
    pis += [(_C.ACC + rep, 0) for rep in range(NUM_REPS)]
    pis += [(_C.ACC + rep, n - 1) for rep in range(NUM_REPS)]
    pis += [(_C.DIGA + j, n - 1) for j in range(8)]
    pis += [(_C.V, 0), (_C.CNT, 0), (_C.CNT, n - 1)]

    return pk.PlonkishIR(
        log_n=log_n, num_witness=NUM_WITNESS, num_const=NUM_CONST,
        gate_degree=5, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis))


def _const_rows(geo: DecommitterGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n, R = geo.n, ROWS_PER_INVOCATION
    span = geo.capacity * R
    rows = round_const_rows(n, geo.capacity, NUM_CONST, K_SR, K_SS2, K_SA,
                            K_SO, K_K)
    rows[R - 1:span:R, K_SH] = 1      # chain into the next absorb row
    rows[R - 1:span:R, K_SB] = 1
    rows[:, K_SC] = 1                 # acc/cnt carried outside absorb rows
    rows[0:span:R, K_SC] = 0
    rows[:, K_SD] = 1                 # digest accumulators carried
    rows[NUM_ROUNDS:span:R, K_SD] = 0
    rows[n - 1, [K_SH, K_SB, K_SC, K_SD]] = 0
    rows[0, K_SF] = 1
    rows[n - 1, K_SW] = 1
    return rows


def decommitter_setup(ir: pk.PlonkishIR, geo: DecommitterGeometry,
                      cfg: pk.PlonkishConfig, device=None
                      ) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    return pk.build_setup(ir, _const_rows(geo).T, pk.CopyWiring.identity(),
                          cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def blocks_for_bytecode(words: Sequence[int]) -> List[bytes]:
    """sha256 padding of the 32-byte-word stream into 64-byte blocks."""
    data = b"".join(int(w).to_bytes(32, "big") for w in words)
    bitlen = len(data) * 8
    padded = bytearray(data) + b"\x80"
    while len(padded) % 64 != 56:
        padded += b"\x00"
    padded += bitlen.to_bytes(8, "big")
    return [bytes(padded[i:i + 64]) for i in range(0, len(padded), 64)]


def fingerprint(challenges: Sequence[int], gammas: Sequence[int],
                blocks: Sequence[bytes],
                acc_in: Sequence[int] = (1, 1)) -> List[int]:
    accs = [int(a) % P for a in acc_in]
    for block in blocks:
        limbs = struct.unpack(">16I", block)
        for rep in range(NUM_REPS):
            ch, gm = int(challenges[rep]) % P, int(gammas[rep]) % P
            t = gm
            pw = ch
            for limb in limbs:
                t = (t + pw * limb) % P
                pw = pw * ch % P
            accs[rep] = accs[rep] * t % P
    return accs


@dataclasses.dataclass
class DecommitterInstanceInputs:
    """One bytecode's hash: the padded sha256 blocks in order."""
    blocks: List[bytes]
    challenges: Tuple[int, int]
    gammas: Tuple[int, int]


def decommitter_witness(ir: pk.PlonkishIR, geo: DecommitterGeometry,
                        inst: DecommitterInstanceInputs, device=None
                        ) -> gl.GF:
    """The (num_witness, n) witness on `device` (`None` means the CUDA
    card)."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = len(inst.blocks)
    assert 1 <= count <= cap
    R = ROWS_PER_INVOCATION
    span = cap * R
    h_ins = np.zeros((count + 1, 8), dtype=np.uint64)
    traces = []
    h = list(_IV)
    for k, block in enumerate(inst.blocks):
        h_ins[k] = h
        traces.append(compression_trace(tuple(h), block))
        h = [int(x) for x in traces[-1].digest]
    tr = stacked_traces(traces)
    src = slot_sources(count, cap)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    place_round_core(W, tr, h_ins, src)
    # the digest carried to the chain row
    place_rows(W, _C.D, tr.digest[:, None], slice(NUM_ROUNDS + 1,
                                                  NUM_ROUNDS + 2), R, src)

    gm = [int(g) % P for g in inst.gammas]
    pows = challenge_powers(inst.challenges, BLK_LIMBS)
    small = np.zeros((NUM_WITNESS - _C.DIGA, n), dtype=np.uint64)
    S = lambda col: small[col - _C.DIGA]
    slot = lambda col: S(col)[:span].reshape(cap, R)
    for rep in range(NUM_REPS):
        for j in range(BLK_LIMBS):
            S(_C.PCH + rep * BLK_LIMBS + j)[:] = pows[rep][j]
        S(_C.GAMMA + rep)[:] = gm[rep]
    diga_slots = small[:8, :span].reshape(8, cap, R)
    accs = [1, 1]
    cnt = 0
    diga = [0] * 8
    for k in range(cap):
        valid = k < count
        for rep in range(NUM_REPS):
            slot(_C.ACC + rep)[k, 0] = accs[rep]
        slot(_C.CNT)[k, 0] = cnt
        if valid:
            limbs = struct.unpack(">16I", inst.blocks[k])
            for rep in range(NUM_REPS):
                t = gm[rep]
                for j in range(BLK_LIMBS):
                    t = (t + pows[rep][j] * limbs[j]) % P
                accs[rep] = accs[rep] * t % P
            cnt += 1
        for rep in range(NUM_REPS):
            slot(_C.ACC + rep)[k, 1:] = accs[rep]
        slot(_C.CNT)[k, 1:] = cnt
        diga_slots[:, k, :NUM_ROUNDS + 1] = \
            np.array(diga, dtype=np.uint64)[:, None]
        if valid:
            diga = [int(x) for x in tr.digest[k]]
        diga_slots[:, k, NUM_ROUNDS + 1:] = \
            np.array(diga, dtype=np.uint64)[:, None]
        slot(_C.V)[k] = 1 if valid else 0
    for rep in range(NUM_REPS):
        S(_C.ACC + rep)[span:] = accs[rep]
    S(_C.CNT)[span:] = cnt
    small[:8, span:] = np.array(diga, dtype=np.uint64)[:, None]
    W[_C.DIGA:] = gl.from_u64(small, device)
    return W


def expected_public_inputs(geo: DecommitterGeometry,
                           inst: DecommitterInstanceInputs) -> List[int]:
    acc_out = fingerprint(inst.challenges, inst.gammas, inst.blocks)
    h = list(_IV)
    for block in inst.blocks:
        _, _, h = sha256_round_trace(tuple(h), block)
    out = []
    for rep in range(NUM_REPS):
        out += [int(inst.challenges[rep]) % P, int(inst.gammas[rep]) % P]
    out += [1, 1]
    out += acc_out
    out += [int(v) for v in h]
    out += [1, 0, len(inst.blocks)]
    return out


def digest_bytes(pis: Sequence[int]) -> bytes:
    """Recover the sha256 digest from the 8 limb PIs."""
    limbs = [int(v) for v in pis[-11:-3]]
    return b"".join(int(x).to_bytes(4, "big") for x in limbs)


def draw_decommitter_challenges(blocks: Sequence[bytes], device=None
                                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Fiat-Shamir challenges bound to the block words; the hash and the
    transcript run on `device` (`None` means the CUDA card)."""
    from ..ops import poseidon2 as p2
    from ..prover.transcript import Transcript
    device = gl.resolve_device(device)
    tr = Transcript(domain_tag=3, device=device)
    flat = []
    for block in blocks:
        flat += list(struct.unpack(">16I", block))
    digest = gl.to_ints(p2.hash_elements(gl.from_int(
        [v % P for v in flat] or [0], device)))
    tr.absorb_ints([int(v) for v in digest] + [len(blocks)])
    ch = (tr.challenge_base(), tr.challenge_base())
    gm = (tr.challenge_base(), tr.challenge_base())
    return ch, gm


def instance_inputs(words: Sequence[int], challenges=None, gammas=None,
                    device=None) -> DecommitterInstanceInputs:
    """One fresh bytecode (32-byte words) -> the circuit payload; the
    challenges are drawn on `device` unless given."""
    blocks = blocks_for_bytecode(words)
    if challenges is None or gammas is None:
        challenges, gammas = draw_decommitter_challenges(blocks,
                                                         device=device)
    return DecommitterInstanceInputs(
        blocks=blocks, challenges=tuple(challenges), gammas=tuple(gammas))
