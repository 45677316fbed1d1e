"""Keccak-f[1600] round-function circuit: the type-5 compute core.

The reference keccak circuit
(circuit_definitions base_layer keccak256_round_function + the decomposer
src/witness/individual_circuits/keccak256_round_function.rs:23) proves
batches of keccak-f permutations driven by the demuxed precompile queue.
This module proves the PERMUTATIONS — the hot compute — with the
per-invocation (input state, output state) pairs bound to the witness
decomposer's replay (witness/precompile_rounds.py) through a
Reed-Solomon-fingerprint accumulator.

Bit-column layout (no lookup tables):
  - 1600 state-bit columns A[lane][z]; row 32k+r holds the state ENTERING
    round r of invocation k (24 round rows + row 24 = output; rows 25..31
    idle carry);
  - theta parities C[x][z] materialized (320 cols, degree-5 xor), the
    post-theta state AP materialized (1600 cols, degree-3), rho/pi are free
    column rewires, chi+iota feed the next row (degree-3 with round
    constants in 64 const columns);
  - booleanity enforced on every absorbed state bit;
  - binding: 2 independent fingerprints  acc *= gamma + sum_j limb_j ch^j
    over the 100 32-bit limbs of (state_in, state_out) per invocation
    (challenge powers materialized in 100 columns per repetition, state_in
    staged through a carried partial sum so the row-24 gate sees both
    halves); challenges and accumulator ends are public inputs drawn by the
    decomposer AFTER committing the invocation data;
  - FSM: per-block validity flags + invocation count chain across
    instances (acc_in/out, cnt_in/out public inputs).

state_in here is the POST-ABSORB state (state xor block).

Counterpart of the JAX package's `circuits/keccak_circuit.py`. The port's
differences, none in what is computed: on the device algebra
(`stacks_tiles`) the round core, the booleanity and the fingerprint sums
are evaluated with every (lane, bit) stacked into one tensor, one launch per
operation for all of them, and the constraint values come out in the JAX
package's order (the host algebras run the JAX package's loops); the
constant rows are uint64 numpy; the witness is built as bit planes,
vectorised over invocations (a keccak-f trace in Python only per valid
invocation, every unused slot the trace of the zero state), and handed to
the device as int64 (the bit planes of each distinct trace cross once and
are gathered into their slots there).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from ..utils.keccak import _RC, _ROT

P = gl.P
ROWS_PER_INVOCATION = 32
NUM_ROUNDS = 24
NUM_LANES = 25
NUM_BITS = 64 * NUM_LANES          # 1600
NUM_LIMBS = 2 * NUM_LANES          # 50 32-bit limbs per state
NUM_REPS = 2
POWS_PER_REP = 2 * NUM_LIMBS       # 100 challenge powers


class _C:
    """Column offsets."""
    A = 0
    CP = NUM_BITS                       # 320 theta parity columns
    AP = NUM_BITS + 320                 # 1600 post-theta columns
    PCH = 2 * NUM_BITS + 320            # 2 reps x 100 challenge powers
    GAMMA = PCH + NUM_REPS * POWS_PER_REP   # 2 gamma columns
    SIN = GAMMA + NUM_REPS              # 2 carried input-half sums
    ACC = SIN + NUM_REPS                # 2 accumulators
    V = ACC + NUM_REPS                  # block validity
    CNT = V + 1


NUM_WITNESS = _C.CNT + 1

# const columns: s_round, s_absorb, s_out, s_carry (acc/cnt carry rows),
# s_bend (block end, no wrap), s_sin_carry, s_wrap (row n-1),
# 64 iota RC bit columns
K_SR, K_SA, K_SO, K_SC, K_SB, K_SS, K_SW = 0, 1, 2, 3, 4, 5, 6
K_RC = 7
NUM_CONST = K_RC + 64


def _pi_inverse():
    """For output lane (x,y): the (a,b) with pi(a,b) = (x,y), where
    pi(a,b) = (b, (2a+3b) % 5)."""
    inv = {}
    for a in range(5):
        for b in range(5):
            inv[(b, (2 * a + 3 * b) % 5)] = (a, b)
    return inv


_PI_INV = _pi_inverse()


def _lane_col(x: int, y: int, z: int, base: int) -> int:
    """Flat column of bit z of lane (x, y): lane index l = x + 5y (the
    decomposer's flat_in ordering, state[i%5][i//5])."""
    return base + 64 * (x + 5 * y) + z


def _one_minus(alg, v):
    return alg.add_int(alg.mul_int(v, P - 1), 1)


def _xor(alg, a, b):
    # a ^ b = a + b - 2ab for boolean a, b
    return alg.sub(alg.add(a, b), alg.mul_int(alg.mul(a, b), 2))


# ---------------------------------------------------------------------------
# Stacked evaluation helpers (device algebra)
# ---------------------------------------------------------------------------

def stacks(alg) -> bool:
    """True for the device algebra, which evaluates stacked tensors."""
    return getattr(alg, "stacks_tiles", False)


def col_stack(cols, start: int, count: int) -> torch.Tensor:
    """Columns [start, start + count) as one (count, n) tensor."""
    return torch.stack(list(cols[start:start + count]))


def rows_of(t: torch.Tensor) -> List[torch.Tensor]:
    """A stacked (..., n) tensor as its list of (n,) rows, in index order."""
    return list(t.reshape(-1, t.shape[-1]).unbind(0))


def bit_weights(count: int, like: torch.Tensor) -> torch.Tensor:
    """(count, 1) field tensor of 2^0 .. 2^(count-1)."""
    return gl.from_int([1 << k for k in range(count)],
                       like.device).reshape(count, 1)


def words_of_bits(alg, bits: torch.Tensor) -> torch.Tensor:
    """(..., 32, n) bits -> (..., n) sum_k bit_k 2^k."""
    return gl.sum_axis(alg.mul(bits, bit_weights(bits.shape[-2], bits)),
                       axis=-2)


def _chi_index() -> np.ndarray:
    """idx[y][x][z]: the post-theta column (lane (a,b) = pi^-1(x,y), bit
    (z - rot[a][b]) % 64) that rho/pi move to bit z of lane (x, y)."""
    idx = np.empty((5, 5, 64), dtype=np.int64)
    for x in range(5):
        for y in range(5):
            a, b = _PI_INV[(x, y)]
            for z in range(64):
                idx[y, x, z] = 64 * (a + 5 * b) + (z - _ROT[a][b]) % 64
    return idx


_CHI_INDEX = _chi_index()


def _core_gates_stacked(alg, w, w_next, c, s_r, rc_base) -> List:
    n = s_r.shape[-1]
    A = col_stack(w, _C.A, NUM_BITS).reshape(5, 5, 64, n)      # [y][x][z]
    A_n = col_stack(w_next, _C.A, NUM_BITS).reshape(5, 5, 64, n)
    CP = col_stack(w, _C.CP, 320).reshape(5, 64, n)            # [x][z]
    AP = col_stack(w, _C.AP, NUM_BITS)
    out = []
    # theta parities, order (x, z)
    p5 = A[0]
    for y in range(1, 5):
        p5 = _xor(alg, p5, A[y])
    out += rows_of(alg.mul(s_r, alg.sub(CP, p5)))
    # post-theta, order (x, z, y); D[x][z] = C[x-1][z] ^ C[x+1][z-1]
    d = _xor(alg, torch.roll(CP, 1, 0),
             torch.roll(torch.roll(CP, -1, 0), 1, 1))
    apc = alg.mul(s_r, alg.sub(AP.reshape(5, 5, 64, n), _xor(alg, A, d)))
    out += rows_of(apc.permute(1, 2, 0, 3))
    del apc, d
    # rho/pi rewire + chi + iota into the next row, order (x, y, z)
    idx = torch.from_numpy(_CHI_INDEX.reshape(-1)).to(AP.device)
    B = AP.index_select(0, idx).reshape(5, 5, 64, n)           # [y][x][z]
    chi = _xor(alg, B, alg.mul(_one_minus(alg, torch.roll(B, -1, 1)),
                               torch.roll(B, -2, 1)))
    del B
    res = alg.mul(s_r, alg.sub(A_n, chi))
    RC = col_stack(c, rc_base, 64)
    res00 = alg.mul(s_r, alg.sub(A_n[0, 0], _xor(alg, chi[0, 0], RC)))
    rows = rows_of(res.permute(1, 0, 2, 3))
    rows[:64] = rows_of(res00)
    return out + rows


def keccak_core_gates(alg, w, w_next, c, s_r, rc_base: int = K_RC) -> List:
    """The keccak-f round core on the A / CP / AP column blocks, each value
    gated by `s_r`: 320 theta parities, 1600 post-theta bits, 1600
    chi + iota bits of the next row (the iota bits are the 64 constant
    columns from `rc_base`). Shared with the L1-messages hasher."""
    if stacks(alg):
        return _core_gates_stacked(alg, w, w_next, c, s_r, rc_base)
    out = []
    A = lambda x, y, z: w[_lane_col(x, y, z, _C.A)]
    A_n = lambda x, y, z: w_next[_lane_col(x, y, z, _C.A)]
    CP = lambda x, z: w[_C.CP + 64 * x + z]
    AP = lambda x, y, z: w[_lane_col(x, y, z, _C.AP)]

    # theta parities: C[x][z] = xor of the column's 5 bits (degree 5)
    for x in range(5):
        for z in range(64):
            p5 = A(x, 0, z)
            for y in range(1, 5):
                p5 = _xor(alg, p5, A(x, y, z))
            out.append(alg.mul(s_r, alg.sub(CP(x, z), p5)))
    # post-theta: AP[x][y][z] = A ^ D, D = C[x-1][z] ^ C[x+1][z-1]
    for x in range(5):
        for z in range(64):
            d = _xor(alg, CP((x + 4) % 5, z), CP((x + 1) % 5, (z + 63) % 64))
            for y in range(5):
                out.append(alg.mul(s_r, alg.sub(
                    AP(x, y, z), _xor(alg, A(x, y, z), d))))

    # rho/pi rewire + chi + iota into the next row
    def B(x, y, z):
        a, b = _PI_INV[(x, y)]
        return AP(a, b, (z - _ROT[a][b]) % 64)

    for x in range(5):
        for y in range(5):
            for z in range(64):
                chi = _xor(alg, B(x, y, z),
                           alg.mul(_one_minus(alg, B((x + 1) % 5, y, z)),
                                   B((x + 2) % 5, y, z)))
                if x == 0 and y == 0:
                    chi = _xor(alg, chi, c[rc_base + z])
                out.append(alg.mul(s_r, alg.sub(A_n(x, y, z), chi)))
    return out


def validity_count_gates(alg, v, v_n, cnt, cnt_n, s_b, s_w, s_step, s_c
                         ) -> List:
    """The five validity / count chain constraints (the count steps by v at
    the `s_step` rows and carries at the `s_c` rows)."""
    return [alg.sub(alg.mul(v, v), v),
            alg.mul(s_b, alg.mul(v_n, _one_minus(alg, v))),
            alg.mul(_one_minus(alg, alg.add(s_b, s_w)), alg.sub(v_n, v)),
            alg.mul(s_step, alg.sub(cnt_n, alg.add(cnt, v))),
            alg.mul(s_c, alg.sub(cnt_n, cnt))]


def challenge_power_gates(alg, w, w_next, pch_base: int, count: int,
                          gamma_col: int, s_a) -> List:
    """gamma and the `count` challenge powers constant down the trace, and
    pch[j+1] = pch[j] * pch[0] at the absorb rows (1 + count + count - 1
    values)."""
    out = [alg.sub(w_next[gamma_col], w[gamma_col])]
    if stacks(alg):
        pch = col_stack(w, pch_base, count)
        out += rows_of(alg.sub(col_stack(w_next, pch_base, count), pch))
        out += rows_of(alg.mul(s_a, alg.sub(pch[1:],
                                            alg.mul(pch[:-1], pch[0]))))
        return out
    pch = [w[pch_base + j] for j in range(count)]
    for j in range(count):
        out.append(alg.sub(w_next[pch_base + j], pch[j]))
    for j in range(count - 1):
        out.append(alg.mul(s_a, alg.sub(pch[j + 1],
                                        alg.mul(pch[j], pch[0]))))
    return out


class LazyWords:
    """Word values on the host algebras, formed anew at each access and in
    the order they are read: the JAX package's list path forms a word
    where it uses it, and the in-circuit verifier replays exactly those
    algebra calls, so reusing a formed word would change its circuit."""

    def __init__(self, make, count: int):
        self._make, self._count = make, count

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, j: int):
        return self._make(j)

    def __iter__(self):
        return (self._make(j) for j in range(self._count))

    @staticmethod
    def concat(*groups) -> "LazyWords":
        index = [(g, j) for g in groups for j in range(len(g))]
        return LazyWords(lambda i: index[i][0][index[i][1]], len(index))


def dot_powers(alg, w, pch_base: int, values):
    """sum_j pch[j] * values[j] over the challenge-power columns from
    `pch_base` (values: a list, or a stacked (k, n) tensor)."""
    if stacks(alg):
        pch = col_stack(w, pch_base, values.shape[0])
        return gl.sum_axis(alg.mul(pch, values), axis=0)
    acc = None
    for j, val in enumerate(values):
        term = alg.mul(w[pch_base + j], val)
        acc = term if acc is None else alg.add(acc, term)
    return acc


@dataclasses.dataclass(frozen=True)
class KeccakGeometry:
    log_n: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def capacity(self) -> int:
        """keccak-f invocations per instance
        (cycles_per_keccak256_circuit analogue)."""
        return self.n // ROWS_PER_INVOCATION


def keccak_ir(log_n: int) -> pk.PlonkishIR:
    geo = KeccakGeometry(log_n)
    n = geo.n
    assert n >= ROWS_PER_INVOCATION

    def eval_gates(alg, w, w_next, c):
        s_r, s_a, s_o = c[K_SR], c[K_SA], c[K_SO]
        s_c, s_b, s_s, s_w = c[K_SC], c[K_SB], c[K_SS], c[K_SW]
        out = keccak_core_gates(alg, w, w_next, c, s_r)

        # booleanity of the absorbed state; the 50 32-bit limbs of the row
        if stacks(alg):
            bits = col_stack(w, _C.A, NUM_BITS)
            out += rows_of(alg.mul(s_a, alg.sub(alg.mul(bits, bits), bits)))
            limbs = words_of_bits(alg, bits.reshape(NUM_LIMBS, 32, -1))
            del bits
        else:
            for l in range(NUM_LANES):
                for z in range(64):
                    b = w[_C.A + 64 * l + z]
                    out.append(alg.mul(s_a, alg.sub(alg.mul(b, b), b)))

            def limb(j):
                """32-bit limb j of the state: lane j//2, half j%2."""
                acc_ = None
                for k in range(32):
                    term = alg.mul_int(w[_C.A + 32 * j + k], 1 << k)
                    acc_ = term if acc_ is None else alg.add(acc_, term)
                return acc_

            limbs = LazyWords(limb, NUM_LIMBS)

        v, v_n = w[_C.V], w_next[_C.V]
        out += validity_count_gates(alg, v, v_n, w[_C.CNT], w_next[_C.CNT],
                                    s_b, s_w, s_o, s_c)

        for rep in range(NUM_REPS):
            pbase = _C.PCH + rep * POWS_PER_REP
            gamma = w[_C.GAMMA + rep]
            sin, sin_n = w[_C.SIN + rep], w_next[_C.SIN + rep]
            acc, acc_n = w[_C.ACC + rep], w_next[_C.ACC + rep]
            # challenge powers: globally constant; pch[j+1] = pch[j]*pch[0]
            out += challenge_power_gates(alg, w, w_next, pbase, POWS_PER_REP,
                                         _C.GAMMA + rep, s_a)
            # input-half sum staged at the absorb row, carried to row 24
            s_in = dot_powers(alg, w, pbase, limbs)
            out.append(alg.mul(s_a, alg.sub(sin, s_in)))
            out.append(alg.mul(s_s, alg.sub(sin_n, sin)))
            # accumulator step at row 24 (the OUT limbs come from w there)
            s_out = dot_powers(alg, w, pbase + NUM_LIMBS, limbs)
            t = alg.add(gamma, alg.add(sin, s_out))
            gated = alg.add(alg.mul(v, t), _one_minus(alg, v))
            out.append(alg.mul(s_o, alg.sub(acc_n, alg.mul(acc, gated))))
            out.append(alg.mul(s_c, alg.sub(acc_n, acc)))
        return out

    n_constraints = (320 + NUM_BITS + NUM_BITS       # theta, AP, chi
                     + NUM_BITS                      # booleanity
                     + 5                             # v/cnt chains
                     + NUM_REPS * (1 + POWS_PER_REP  # gamma/pch constancy
                                   + POWS_PER_REP - 1  # pch definition
                                   + 2 + 2))         # sin + acc

    pis: List[Tuple[int, int]] = []
    for rep in range(NUM_REPS):
        pis.append((_C.PCH + rep * POWS_PER_REP, 0))   # the challenge
        pis.append((_C.GAMMA + rep, 0))
    pis += [(_C.ACC + rep, 0) for rep in range(NUM_REPS)]
    pis += [(_C.ACC + rep, n - 1) for rep in range(NUM_REPS)]
    pis += [(_C.V, 0), (_C.CNT, 0), (_C.CNT, n - 1)]

    return pk.PlonkishIR(
        log_n=log_n, num_witness=NUM_WITNESS, num_const=NUM_CONST,
        gate_degree=8, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis))


def rc_bits() -> np.ndarray:
    """(24, 64) uint64 bits of the iota round constants."""
    rc = np.array(_RC, dtype=np.uint64)
    return (rc[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)


def _const_rows(geo: KeccakGeometry) -> np.ndarray:
    """(n, NUM_CONST) uint64 constant rows."""
    n = geo.n
    block = np.zeros((ROWS_PER_INVOCATION, NUM_CONST), dtype=np.uint64)
    block[:NUM_ROUNDS, K_SR] = 1
    block[:NUM_ROUNDS, K_RC:K_RC + 64] = rc_bits()
    block[0, K_SA] = 1
    block[NUM_ROUNDS, K_SO] = 1
    block[:NUM_ROUNDS, K_SS] = 1     # SIN carried through round rows
    block[:, K_SC] = 1               # acc/cnt carried elsewhere (no wrap)
    block[NUM_ROUNDS, K_SC] = 0
    block[ROWS_PER_INVOCATION - 1, K_SB] = 1     # block end
    rows = np.tile(block, (n // ROWS_PER_INVOCATION, 1))
    rows[n - 1, K_SC] = 0
    rows[n - 1, K_SB] = 0
    rows[n - 1, K_SW] = 1
    return rows


def keccak_setup(ir: pk.PlonkishIR, geo: KeccakGeometry,
                 cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    return pk.build_setup(ir, _const_rows(geo).T, pk.CopyWiring.identity(),
                          cfg, device=device)


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def keccak_round_trace(state_in: Sequence[int]):
    """Per-round bit traces for one keccak-f: returns (A_rows (25, 25 lanes),
    C_rows (24, 5), AP_rows (24, 25)) as u64 lane values; A_rows[r] is the
    state entering round r, A_rows[24] the output."""
    a = [[int(state_in[x + 5 * y]) for y in range(5)] for x in range(5)]
    A_rows, C_rows, AP_rows = [], [], []

    def flat(m):
        return [m[i % 5][i // 5] for i in range(25)]

    M = (1 << 64) - 1
    for rnd in range(NUM_ROUNDS):
        A_rows.append(flat(a))
        cpar = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
                for x in range(5)]
        C_rows.append(list(cpar))
        d = [cpar[(x - 1) % 5]
             ^ (((cpar[(x + 1) % 5] << 1) | (cpar[(x + 1) % 5] >> 63)) & M)
             for x in range(5)]
        ap = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        AP_rows.append(flat(ap))
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                r = _ROT[x][y]
                b[y][(2 * x + 3 * y) % 5] = \
                    (((ap[x][y] << r) | (ap[x][y] >> (64 - r))) & M)
        a = [[b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & M)
              for y in range(5)] for x in range(5)]
        a[0][0] ^= _RC[rnd]
    A_rows.append(flat(a))
    return A_rows, C_rows, AP_rows


def round_traces(states: Sequence[Sequence[int]]):
    """Round traces of keccak-f of each state, then of the zero state (the
    trace every unused slot holds), as uint64 arrays (A (u, 25, 25),
    C (u, 24, 5), AP (u, 24, 25)), u = len(states) + 1."""
    traces = [keccak_round_trace(st) for st in states]
    traces.append(keccak_round_trace([0] * 25))
    return tuple(np.array([t[i] for t in traces], dtype=np.uint64)
                 for i in range(3))


def slot_sources(count: int, slots: int) -> np.ndarray:
    """The trace each of `slots` slots holds: slot k < count its own, every
    other the last (the unused slots' shared trace)."""
    return np.minimum(np.arange(slots), count)


def lane_bits(lanes: np.ndarray) -> np.ndarray:
    """uint64 lanes (...,) -> uint8 bits (..., 64), least significant
    first."""
    return ((lanes[..., None] >> np.arange(64, dtype=np.uint64))
            & np.uint64(1)).astype(np.uint8)


def place_rows(W: torch.Tensor, col: int, vals: np.ndarray, rows: slice,
               period: int, src: np.ndarray):
    """W[col + i, k * period + r] = vals[src[k], r, i] for the rows r of
    `rows` in every period-row slot k. vals: (traces, rows, width), one per
    distinct trace; src: the trace of each slot. Only the distinct traces
    cross to the device; the slots are gathered there."""
    width = vals.shape[2]
    slots = len(src)
    dst = W[col:col + width, :slots * period].view(width, slots, period)
    planes = np.ascontiguousarray(vals.transpose(2, 0, 1))
    if planes.dtype == np.uint64:  # CUDA gathers no uint64; same bits
        planes = planes.view(np.int64)
    planes = torch.from_numpy(planes).to(W.device)
    dst[:, :, rows] = planes[:, torch.from_numpy(src).to(W.device)]


def state_limbs(lanes: Sequence[int]) -> List[int]:
    """50 32-bit limbs (lane-low, lane-high per lane)."""
    out = []
    for l in lanes:
        out += [int(l) & 0xFFFFFFFF, (int(l) >> 32) & 0xFFFFFFFF]
    return out


def challenge_powers(challenges: Sequence[int], count: int) -> List[List[int]]:
    """Per repetition the powers ch, ch^2, ..., ch^count."""
    pows = []
    for ch in challenges:
        ch = int(ch) % P
        pw, row = ch, []
        for _ in range(count):
            row.append(pw)
            pw = pw * ch % P
        pows.append(row)
    return pows


def fingerprint(challenges: Sequence[int], gammas: Sequence[int],
                pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
                acc_in: Sequence[int] = (1, 1)) -> List[int]:
    """Host-side accumulator over (state_in, state_out) lane pairs — what
    the circuit's public accumulator outputs must equal."""
    accs = [int(a) % P for a in acc_in]
    for (si, so) in pairs:
        limbs = state_limbs(si) + state_limbs(so)
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
class KeccakInstanceInputs:
    """One instance's payload: post-absorb input states and output states."""
    state_pairs: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]
    challenges: Tuple[int, int]
    gammas: Tuple[int, int]
    acc_in: Tuple[int, int]
    cnt_in: int


def keccak_witness(ir: pk.PlonkishIR, geo: KeccakGeometry,
                   inst: KeccakInstanceInputs, device=None) -> gl.GF:
    """The (num_witness, n) witness on `device` (`None` means the CUDA
    card)."""
    device = gl.resolve_device(device)
    n, cap = geo.n, geo.capacity
    count = len(inst.state_pairs)
    assert count <= cap
    R = ROWS_PER_INVOCATION
    A, C, AP = round_traces([si for si, _ in inst.state_pairs])
    for k, (_si, so) in enumerate(inst.state_pairs):
        assert tuple(int(v) for v in A[k, NUM_ROUNDS]) == \
            tuple(int(v) for v in so), \
            "state_out does not match keccak-f(state_in)"
    u, src = count + 1, slot_sources(count, cap)
    W = torch.zeros((ir.num_witness, n), dtype=torch.int64, device=device)
    place_rows(W, _C.A, lane_bits(A).reshape(u, NUM_ROUNDS + 1, NUM_BITS),
               slice(0, NUM_ROUNDS + 1), R, src)
    place_rows(W, _C.CP, lane_bits(C).reshape(u, NUM_ROUNDS, 320),
               slice(0, NUM_ROUNDS), R, src)
    place_rows(W, _C.AP, lane_bits(AP).reshape(u, NUM_ROUNDS, NUM_BITS),
               slice(0, NUM_ROUNDS), R, src)
    del A, C, AP

    gm = [int(g) % P for g in inst.gammas]
    pows = challenge_powers(inst.challenges, POWS_PER_REP)
    small = np.zeros((NUM_WITNESS - _C.PCH, cap, R), dtype=np.uint64)
    S = lambda col: small[col - _C.PCH]
    for rep in range(NUM_REPS):
        for j in range(POWS_PER_REP):
            S(_C.PCH + rep * POWS_PER_REP + j)[:] = pows[rep][j]
        S(_C.GAMMA + rep)[:] = gm[rep]
    accs = [int(a) % P for a in inst.acc_in]
    cnt = int(inst.cnt_in)
    for k in range(cap):
        valid = k < count
        if valid:
            limbs_in = state_limbs(inst.state_pairs[k][0])
            limbs_out = state_limbs(inst.state_pairs[k][1])
        for rep in range(NUM_REPS):
            sin = (sum(pows[rep][j] * limbs_in[j] for j in range(NUM_LIMBS))
                   % P) if valid else 0
            S(_C.SIN + rep)[k, :NUM_ROUNDS + 1] = sin
            S(_C.ACC + rep)[k, :NUM_ROUNDS + 1] = accs[rep]
            if valid:
                sout = sum(pows[rep][NUM_LIMBS + j] * limbs_out[j]
                           for j in range(NUM_LIMBS)) % P
                accs[rep] = accs[rep] * ((gm[rep] + sin + sout) % P) % P
            S(_C.ACC + rep)[k, NUM_ROUNDS + 1:] = accs[rep]
        S(_C.V)[k] = 1 if valid else 0
        S(_C.CNT)[k, :NUM_ROUNDS + 1] = cnt
        if valid:
            cnt += 1
        S(_C.CNT)[k, NUM_ROUNDS + 1:] = cnt
    W[_C.PCH:] = gl.from_u64(small.reshape(-1, n), device)
    return W


def expected_public_inputs(geo: KeccakGeometry, inst: KeccakInstanceInputs
                           ) -> List[int]:
    acc_out = fingerprint(inst.challenges, inst.gammas,
                          inst.state_pairs, inst.acc_in)
    out = []
    for rep in range(NUM_REPS):
        out += [int(inst.challenges[rep]) % P, int(inst.gammas[rep]) % P]
    out += [int(a) % P for a in inst.acc_in]
    out += acc_out
    out += [1 if inst.state_pairs else 0,
            int(inst.cnt_in), int(inst.cnt_in) + len(inst.state_pairs)]
    return out


def instance_public_inputs(geo: KeccakGeometry, inst_w, challenges_gammas
                           ) -> List[int]:
    """PIs from a decomposer-level RoundFunctionInstanceWitness
    (witness/precompile_circuits.py) — the typed-layer-surface bridge."""
    ch, gm = challenges_gammas
    inst = instance_inputs(inst_w.invocations, ch, gm, inst_w.acc_in,
                           inst_w.cnt_in)
    return expected_public_inputs(geo, inst)


def _post_absorb(inv) -> Tuple[int, ...]:
    return tuple(
        si ^ (int.from_bytes(inv.block[8 * i:8 * i + 8], "little")
              if 8 * i < len(inv.block) else 0)
        for i, si in enumerate(inv.state_in))


def draw_keccak_challenges(invocations, device=None
                           ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Fiat-Shamir challenges bound to the invocation data (drawn AFTER
    committing it, like the sorters' permutation challenges); the hash and
    the transcript run on `device` (`None` means the CUDA card)."""
    from ..ops import poseidon2 as p2
    from ..prover.transcript import Transcript
    device = gl.resolve_device(device)
    tr = Transcript(domain_tag=5, device=device)
    flat = []
    for inv in invocations:
        flat += state_limbs(_post_absorb(inv)) + state_limbs(inv.state_out)
    digest = gl.to_ints(p2.hash_elements(gl.from_int(
        [v % P for v in flat] or [0], device)))
    tr.absorb_ints([int(v) for v in digest] + [len(invocations)])
    ch = (tr.challenge_base(), tr.challenge_base())
    gm = (tr.challenge_base(), tr.challenge_base())
    return ch, gm


def instance_inputs(invocations, challenges, gammas, acc_in=(1, 1),
                    cnt_in: int = 0) -> KeccakInstanceInputs:
    """Bridge decomposer RoundFunctionInvocations (witness/
    precompile_rounds.py) into the circuit payload: state_in here is the
    POST-ABSORB state."""
    pairs = [(_post_absorb(inv), tuple(int(v) for v in inv.state_out))
             for inv in invocations]
    return KeccakInstanceInputs(state_pairs=pairs,
                                challenges=tuple(challenges),
                                gammas=tuple(gammas),
                                acc_in=tuple(acc_in), cnt_in=cnt_in)
