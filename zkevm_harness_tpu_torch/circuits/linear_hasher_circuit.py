"""L1-messages linear-hasher circuit (type 13): an in-circuit keccak256.

The reference circuit (circuit_definitions base_layer L1MessagesHasher +
src/witness/individual_circuits/data_hasher_and_merklizer.rs:8) pops the
deduplicated L1-message queue, hashes the serialized bytes with keccak256,
and exposes the digest. This module proves the FULL SPONGE in-circuit —
unlike the type-5 round-function circuit, consecutive permutations are
chained by constraint (state_in[k+1] = state_out[k] xor block[k+1] on the
17 absorbed lanes, carried capacity lanes), the initial state is pinned to
zero, and the digest limbs are extracted into accumulator columns that the
public inputs expose. The absorbed blocks are bound by the two-rep
fingerprint accumulator (challenge-after-commit, as everywhere); the
host-side byte serialization of queue elements into blocks is the
remaining witness-side step (witness/linear_hasher.py).

Layout (reusing the type-5 bit-column keccak core):
  - 32 rows per keccak-f invocation: rows 0..23 round states, row 24 the
    output, rows 25..31 carry the output state bits forward so the chain
    constraint at row 31 -> 32 sees both the previous output and the next
    block;
  - BLK: 1088 bit columns holding the absorbed block on each absorb row;
  - DIG: 8 u32 digest-limb accumulators, updated at each output row while
    the invocation is valid (so row n-1 holds the digest of the LAST valid
    permutation — keccak256 of the whole stream);
  - fingerprint: acc *= gamma + sum_j blk_limb_j ch^j per absorb row
    (34 u32 limbs per block), 2 independent reps.

One instance covers one linear hash (the reference's capacity is 774
messages ~ 500 permutations per 2^20-row instance, far above any real
block's L1 stream).

Counterpart of the JAX package's `circuits/linear_hasher_circuit.py`. It
takes its round core from the port's `keccak_circuit` (`keccak_core_gates`,
with this circuit's round-constant columns); on the device algebra the
block, chaining, first-absorb and digest constraints are evaluated stacked
over every (lane, bit), in the JAX package's order (the host algebras run
its loops); the witness is built as bit planes, vectorised over
invocations, as the keccak circuit's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from .keccak_circuit import (NUM_BITS, NUM_LANES, NUM_ROUNDS,
                             LazyWords, challenge_power_gates,
                             challenge_powers, col_stack, dot_powers,
                             keccak_core_gates, keccak_round_trace,
                             lane_bits, place_rows, rc_bits, round_traces,
                             rows_of, slot_sources,
                             stacks, state_limbs, validity_count_gates,
                             words_of_bits, _one_minus, _xor)

P = gl.P
ROWS_PER_INVOCATION = 32
ABSORBED_LANES = 17                 # rate 136 bytes
BLK_BITS = 64 * ABSORBED_LANES      # 1088
NUM_REPS = 2
BLK_LIMBS = 2 * ABSORBED_LANES      # 34 u32 limbs per block
DIGEST_LIMBS = 8                    # first 4 lanes as u32 limbs


class _C:
    """Column offsets."""
    A = 0
    CP = NUM_BITS
    AP = NUM_BITS + 320
    BLK = 2 * NUM_BITS + 320
    DIG = BLK + BLK_BITS
    PCH = DIG + DIGEST_LIMBS
    GAMMA = PCH + NUM_REPS * BLK_LIMBS
    ACC = GAMMA + NUM_REPS
    V = ACC + NUM_REPS
    CNT = V + 1


NUM_WITNESS = _C.CNT + 1

# const columns: s_round, s_absorb, s_out, s_idlecarry (A carried rows
# 24..30), s_chain (row 31 of non-final invocations), s_first (row 0),
# s_acr (acc/cnt carry rows), s_dcr (digest carry rows), s_bend, s_wrap,
# 64 iota RC bit columns
K_SR, K_SA, K_SO, K_SI, K_SH, K_SF, K_SC, K_SD, K_SB, K_SW = range(10)
K_RC = 10
NUM_CONST = K_RC + 64


@dataclasses.dataclass(frozen=True)
class HasherGeometry:
    log_n: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def capacity(self) -> int:
        """keccak-f permutations per instance."""
        return self.n // ROWS_PER_INVOCATION


def _sponge_gates_stacked(alg, w, w_next, s_i, s_h, s_f, v_n):
    A = col_stack(w, _C.A, NUM_BITS)
    A_n = col_stack(w_next, _C.A, NUM_BITS)
    out = []
    # sponge chaining: output state carried through rows 24..30
    out += rows_of(alg.mul(s_i, alg.sub(A_n, A)))
    # row 31 -> 32: absorbed lanes take the next block, capacity lanes carry
    tgt = torch.cat([_xor(alg, A[:BLK_BITS],
                          col_stack(w_next, _C.BLK, BLK_BITS)),
                     A[BLK_BITS:]])
    out += rows_of(alg.mul(alg.mul(s_h, v_n), alg.sub(A_n, tgt)))
    del tgt
    # first absorb: zero initial state
    first = torch.cat([alg.sub(A[:BLK_BITS], col_stack(w, _C.BLK, BLK_BITS)),
                       A[BLK_BITS:]])
    out += rows_of(alg.mul(s_f, first))
    return out


def hasher_ir(log_n: int) -> pk.PlonkishIR:
    geo = HasherGeometry(log_n)
    n = geo.n
    assert geo.capacity >= 1

    def eval_gates(alg, w, w_next, c):
        s_r, s_a, s_o = c[K_SR], c[K_SA], c[K_SO]
        s_i, s_h, s_f = c[K_SI], c[K_SH], c[K_SF]
        s_c, s_d, s_b, s_w = c[K_SC], c[K_SD], c[K_SB], c[K_SW]
        v, v_n = w[_C.V], w_next[_C.V]

        # keccak-f round core (identical to the type-5 circuit)
        out = keccak_core_gates(alg, w, w_next, c, s_r, K_RC)

        if stacks(alg):
            # block booleanity (absorb rows)
            blk = col_stack(w, _C.BLK, BLK_BITS)
            out += rows_of(alg.sub(alg.mul(blk, blk), blk))
            out += _sponge_gates_stacked(alg, w, w_next, s_i, s_h, s_f, v_n)
            state_limbs_ = words_of_bits(
                alg, col_stack(w, _C.A, 32 * DIGEST_LIMBS).reshape(
                    DIGEST_LIMBS, 32, -1))
            blk_limbs = words_of_bits(alg, blk.reshape(BLK_LIMBS, 32, -1))
            del blk
            dig = col_stack(w, _C.DIG, DIGEST_LIMBS)
            dig_n = col_stack(w_next, _C.DIG, DIGEST_LIMBS)
            upd = alg.add(alg.mul(v, state_limbs_),
                          alg.mul(_one_minus(alg, v), dig))
            out += rows_of(torch.stack(
                [alg.mul(s_o, alg.sub(dig_n, upd)),
                 alg.mul(s_d, alg.sub(dig_n, dig))], dim=1))
        else:
            out += _sponge_gates_host(alg, w, w_next, s_i, s_h, s_f, v_n)

            def limb(base, j):
                l, half = j // 2, j % 2
                acc_ = None
                for k in range(32):
                    bit = w[base + 64 * l + 32 * half + k]
                    term = alg.mul_int(bit, 1 << k)
                    acc_ = term if acc_ is None else alg.add(acc_, term)
                return acc_

            for j in range(DIGEST_LIMBS):
                dig, dig_n = w[_C.DIG + j], w_next[_C.DIG + j]
                upd = alg.add(alg.mul(v, limb(_C.A, j)),
                              alg.mul(_one_minus(alg, v), dig))
                out.append(alg.mul(s_o, alg.sub(dig_n, upd)))
                out.append(alg.mul(s_d, alg.sub(dig_n, dig)))
            blk_limbs = LazyWords(lambda j: limb(_C.BLK, j), BLK_LIMBS)

        # validity / count chains
        out += validity_count_gates(alg, v, v_n, w[_C.CNT], w_next[_C.CNT],
                                    s_b, s_w, s_a, s_c)

        # block-binding fingerprints (update at absorb rows)
        for rep in range(NUM_REPS):
            pbase = _C.PCH + rep * BLK_LIMBS
            gamma = w[_C.GAMMA + rep]
            acc, acc_n = w[_C.ACC + rep], w_next[_C.ACC + rep]
            out += challenge_power_gates(alg, w, w_next, pbase, BLK_LIMBS,
                                         _C.GAMMA + rep, s_a)
            t = alg.add(gamma, dot_powers(alg, w, pbase, blk_limbs))
            gated = alg.add(alg.mul(v, t), _one_minus(alg, v))
            out.append(alg.mul(s_a, alg.sub(acc_n, alg.mul(acc, gated))))
            out.append(alg.mul(s_c, alg.sub(acc_n, acc)))
        return out

    n_constraints = (320 + NUM_BITS + NUM_BITS        # keccak core
                     + BLK_BITS                       # block booleanity
                     + NUM_BITS + NUM_BITS + NUM_BITS  # idle/chain/first
                     + 2 * DIGEST_LIMBS               # digest update/carry
                     + 5                              # v/cnt chains
                     + NUM_REPS * (1 + BLK_LIMBS
                                   + BLK_LIMBS - 1 + 2))

    pis: List[Tuple[int, int]] = []
    for rep in range(NUM_REPS):
        pis.append((_C.PCH + rep * BLK_LIMBS, 0))
        pis.append((_C.GAMMA + rep, 0))
    pis += [(_C.ACC + rep, 0) for rep in range(NUM_REPS)]
    pis += [(_C.ACC + rep, n - 1) for rep in range(NUM_REPS)]
    pis += [(_C.DIG + j, n - 1) for j in range(DIGEST_LIMBS)]
    pis += [(_C.V, 0), (_C.CNT, 0), (_C.CNT, n - 1)]

    return pk.PlonkishIR(
        log_n=log_n, num_witness=NUM_WITNESS, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis))


def _sponge_gates_host(alg, w, w_next, s_i, s_h, s_f, v_n):
    """Block booleanity, output carry, chaining and first absorb, as the
    JAX package's loops."""
    out = []
    for b in range(BLK_BITS):
        bit = w[_C.BLK + b]
        out.append(alg.sub(alg.mul(bit, bit), bit))
    for l in range(NUM_LANES):
        for z in range(64):
            a = w[_C.A + 64 * l + z]
            out.append(alg.mul(s_i, alg.sub(w_next[_C.A + 64 * l + z], a)))
    for l in range(NUM_LANES):
        for z in range(64):
            a = w[_C.A + 64 * l + z]
            a_n = w_next[_C.A + 64 * l + z]
            if l < ABSORBED_LANES:
                tgt = _xor(alg, a, w_next[_C.BLK + 64 * l + z])
            else:
                tgt = a
            out.append(alg.mul(alg.mul(s_h, v_n), alg.sub(a_n, tgt)))
    for l in range(NUM_LANES):
        for z in range(64):
            a = w[_C.A + 64 * l + z]
            if l < ABSORBED_LANES:
                out.append(alg.mul(s_f, alg.sub(a, w[_C.BLK + 64 * l + z])))
            else:
                out.append(alg.mul(s_f, a))
    return out


def _const_rows(geo: HasherGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n = geo.n
    R = ROWS_PER_INVOCATION
    block = np.zeros((R, NUM_CONST), dtype=np.uint64)
    block[:NUM_ROUNDS, K_SR] = 1
    block[:NUM_ROUNDS, K_RC:K_RC + 64] = rc_bits()
    block[0, K_SA] = 1
    block[NUM_ROUNDS, K_SO] = 1
    block[NUM_ROUNDS:R - 1, K_SI] = 1     # carry the output state bits
    block[R - 1, K_SH] = 1                # chain into the next absorb row
    block[R - 1, K_SB] = 1                # validity may drop here
    block[1:, K_SC] = 1                   # acc/cnt carried outside absorb
    block[:, K_SD] = 1                    # digest carried outside output
    block[NUM_ROUNDS, K_SD] = 0
    rows = np.tile(block, (n // R, 1))
    rows[n - 1, [K_SH, K_SB, K_SC, K_SD]] = 0
    rows[0, K_SF] = 1
    rows[n - 1, K_SW] = 1
    return rows


def hasher_setup(ir: pk.PlonkishIR, geo: HasherGeometry,
                 cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    return pk.build_setup(ir, _const_rows(geo).T, pk.CopyWiring.identity(),
                          cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def _block_lanes(block: bytes) -> List[int]:
    padded = block + b"\x00" * (136 - len(block))
    return [int.from_bytes(padded[8 * l:8 * l + 8], "little")
            for l in range(ABSORBED_LANES)]


def _block_limbs(block: bytes) -> List[int]:
    out = []
    for lane in _block_lanes(block):
        out += [lane & 0xFFFFFFFF, (lane >> 32) & 0xFFFFFFFF]
    return out


def fingerprint(challenges: Sequence[int], gammas: Sequence[int],
                blocks: Sequence[bytes],
                acc_in: Sequence[int] = (1, 1)) -> List[int]:
    accs = [int(a) % P for a in acc_in]
    for block in blocks:
        limbs = _block_limbs(block)
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
class HasherInstanceInputs:
    """One linear hash: the absorbed blocks (already padded) in order."""
    blocks: List[bytes]
    challenges: Tuple[int, int]
    gammas: Tuple[int, int]


def sponge_states(blocks: Sequence[bytes]) -> List[List[int]]:
    """The post-absorb state of each keccak-f of the sponge over
    `blocks`, from the zero state."""
    state = [0] * NUM_LANES
    posts = []
    for block in blocks:
        post = list(state)
        for l, lane in enumerate(_block_lanes(block)):
            post[l] ^= lane
        posts.append(post)
        state = keccak_round_trace(post)[0][NUM_ROUNDS]
    return posts


def hasher_witness(ir: pk.PlonkishIR, geo: HasherGeometry,
                   inst: HasherInstanceInputs, device=None) -> gl.GF:
    """The (num_witness, n) witness on `device` (`None` means the CUDA
    card)."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = len(inst.blocks)
    assert 1 <= count <= cap
    R = ROWS_PER_INVOCATION
    A, C, AP = round_traces(sponge_states(inst.blocks))
    u, src = count + 1, slot_sources(count, cap)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    bits = lane_bits(A).reshape(u, NUM_ROUNDS + 1, NUM_BITS)
    # output state carried through rows 24..31
    out_bits = np.repeat(bits[:, NUM_ROUNDS:], R - NUM_ROUNDS, axis=1)
    place_rows(W, _C.A, np.concatenate([bits[:, :NUM_ROUNDS], out_bits], 1),
               slice(0, R), R, src)
    del bits, out_bits
    place_rows(W, _C.CP, lane_bits(C).reshape(u, NUM_ROUNDS, 320),
               slice(0, NUM_ROUNDS), R, src)
    place_rows(W, _C.AP, lane_bits(AP).reshape(u, NUM_ROUNDS, NUM_BITS),
               slice(0, NUM_ROUNDS), R, src)
    blk = np.zeros((u, 1, ABSORBED_LANES), dtype=np.uint64)
    for k, block in enumerate(inst.blocks):
        blk[k, 0] = _block_lanes(block)
    place_rows(W, _C.BLK, lane_bits(blk).reshape(u, 1, BLK_BITS),
               slice(0, 1), R, src)

    gm = [int(g) % P for g in inst.gammas]
    pows = challenge_powers(inst.challenges, BLK_LIMBS)
    small = np.zeros((NUM_WITNESS - _C.DIG, cap, R), dtype=np.uint64)
    S = lambda col: small[col - _C.DIG]
    for rep in range(NUM_REPS):
        for j in range(BLK_LIMBS):
            S(_C.PCH + rep * BLK_LIMBS + j)[:] = pows[rep][j]
        S(_C.GAMMA + rep)[:] = gm[rep]
    accs = [1, 1]
    cnt = 0
    dig = [0] * DIGEST_LIMBS
    for k in range(cap):
        valid = k < count
        # fingerprint + count: update fires at the absorb row
        for rep in range(NUM_REPS):
            S(_C.ACC + rep)[k, 0] = accs[rep]
        S(_C.CNT)[k, 0] = cnt
        if valid:
            limbs = _block_limbs(inst.blocks[k])
            for rep in range(NUM_REPS):
                t = gm[rep]
                for j in range(BLK_LIMBS):
                    t = (t + pows[rep][j] * limbs[j]) % P
                accs[rep] = accs[rep] * t % P
            cnt += 1
        for rep in range(NUM_REPS):
            S(_C.ACC + rep)[k, 1:] = accs[rep]
        S(_C.CNT)[k, 1:] = cnt
        # digest accumulators: update fires at the output row
        small[:DIGEST_LIMBS, k, :NUM_ROUNDS + 1] = \
            np.array(dig, dtype=np.uint64)[:, None]
        if valid:
            dig = state_limbs([int(v) for v in A[k, NUM_ROUNDS, :4]])
        small[:DIGEST_LIMBS, k, NUM_ROUNDS + 1:] = \
            np.array(dig, dtype=np.uint64)[:, None]
        S(_C.V)[k] = 1 if valid else 0
    W[_C.DIG:] = gl.from_u64(small.reshape(-1, n), device)
    return W


def expected_public_inputs(geo: HasherGeometry, inst: HasherInstanceInputs
                           ) -> List[int]:
    acc_out = fingerprint(inst.challenges, inst.gammas, inst.blocks)
    # replay the sponge for the digest
    posts = sponge_states(inst.blocks)
    state = keccak_round_trace(posts[-1])[0][NUM_ROUNDS] if posts \
        else [0] * NUM_LANES
    dig = state_limbs(state[:4])
    out = []
    for rep in range(NUM_REPS):
        out += [int(inst.challenges[rep]) % P, int(inst.gammas[rep]) % P]
    out += [1, 1]
    out += acc_out
    out += [int(v) for v in dig]
    out += [1, 0, len(inst.blocks)]
    return out


def digest_bytes(pis: Sequence[int]) -> bytes:
    """Recover the keccak256 digest from the 8 limb PIs (the 8 values
    before the trailing v/cnt_in/cnt_out lanes)."""
    limbs = [int(v) for v in pis[-11:-3]]
    out = b""
    for l in range(4):
        lane = limbs[2 * l] | (limbs[2 * l + 1] << 32)
        out += lane.to_bytes(8, "little")
    return out


def draw_hasher_challenges(blocks: Sequence[bytes], device=None
                           ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Fiat-Shamir challenges bound to the absorbed block stream; the hash
    and the transcript run on `device` (`None` means the CUDA card)."""
    from ..ops import poseidon2 as p2
    from ..prover.transcript import Transcript
    device = gl.resolve_device(device)
    tr = Transcript(domain_tag=13, device=device)
    flat = []
    for block in blocks:
        flat += _block_limbs(block)
    digest = gl.to_ints(p2.hash_elements(gl.from_int(
        [v % P for v in flat] or [0], device)))
    tr.absorb_ints([int(v) for v in digest] + [len(blocks)])
    ch = (tr.challenge_base(), tr.challenge_base())
    gm = (tr.challenge_base(), tr.challenge_base())
    return ch, gm


def blocks_for_data(data: bytes) -> List[bytes]:
    """keccak256 pad10*1 split into rate-sized blocks."""
    padded = bytearray(data)
    pad_len = 136 - (len(padded) % 136)
    if pad_len >= 2:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    else:
        padded += b"\x81"
    return [bytes(padded[i:i + 136]) for i in range(0, len(padded), 136)]


def instance_inputs(data: bytes, challenges=None, gammas=None, device=None
                    ) -> HasherInstanceInputs:
    """The circuit payload of one linear hash of `data`; the challenges are
    drawn on `device` unless given."""
    blocks = blocks_for_data(data)
    if challenges is None or gammas is None:
        challenges, gammas = draw_hasher_challenges(blocks, device=device)
    return HasherInstanceInputs(blocks=blocks, challenges=tuple(challenges),
                                gammas=tuple(gammas))
