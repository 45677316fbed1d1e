"""Storage-application circuit (type 10): Blake2s Merkle paths in-circuit.

The reference circuit (zkevm_circuits storage_application, capacity
cycles_per_storage_application = 33 queries per 2^20-row instance) proves
depth-256 Blake2s tree openings for every deduplicated storage write. This
module proves ONE PATH per instance — leaf hash + D node hashes, chained
by constraint with path-bit-selected sibling placement — on a bit-column
Blake2s core:

  - one row per Blake2s round (10 round rows + output + chain row = 12
    rows per compression); the 16-word working state v lives as 512 bit
    columns; every G function materializes its four addition outputs
    (a', c', a'', c'') as bit columns with boolean carries while the
    xor-rotate halves (b', d', b'', d'') stay algebraic — rotations are
    free bit rewires;
  - the per-round message schedule (SIGMA) is resolved by 10 one-hot
    round selector constants, so the same gate set serves every round;
  - message words are carried bit columns: the LEAF compression absorbs
    enum_index(8B) || value(32B) || zero padding (t = 40), every NODE
    compression absorbs left || right (t = 64) where the running digest
    and the witnessed sibling are swapped by the path bit — the chain is
    enforced between compressions, so the final digest IS the Merkle root
    of the witnessed (leaf, path) under blake2s;
  - public inputs: the leaf message bits, the path bits, and the root
    digest bits (all statically placed — the oracle's tree recomputation
    pins them).

Depth is a geometry parameter: tests run D=4 against a synthetic sparse
tree built with the production leaf/node hash rules (witness/tree.py);
production instantiates D=256 (3084 rows per query).

Counterpart of the JAX package's `circuits/storage_application_circuit.py`.
The port's differences, none in what is computed: on the device algebra
(`stacks_tiles`) each constraint family is one stacked tensor, an operation
one launch for all its members — the booleanity of all 2,609 columns, the
carried message and digest bits, the absorb initialisation, the 32 word
equations of the eight G functions (four at a time, the bit rotations by
`torch.roll`, the round's message words by one gather over the round
selectors), the 512-bit state transition as a (16, 32) block, the digest
and the chain selection — with the values in the JAX package's order (the
host algebras run its loops); the constant rows are uint64 numpy; the
witness is built as uint8 bit planes from the Blake2s rounds of each
compression and crosses to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from .keccak_circuit import col_stack, rows_of, stacks, words_of_bits

P = gl.P
ROWS_PER_COMPRESSION = 12
NUM_ROUNDS = 10

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_H0 = tuple([_IV[0] ^ 0x01010020] + list(_IV[1:]))  # digest_len=32 params
_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_COL_IDX = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
_DIAG_IDX = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x: int, s: int) -> int:
    return ((x >> s) | (x << (32 - s))) & 0xFFFFFFFF


def blake2s_compress(m_words: Sequence[int], t: int) -> List[int]:
    """One final-block compression from the fixed H0 (hashlib.blake2s of a
    single <=64-byte block)."""
    v = list(_H0) + list(_IV)
    v[12] ^= t & 0xFFFFFFFF
    v[14] ^= 0xFFFFFFFF
    for r in range(NUM_ROUNDS):
        s = _SIGMA[r]
        for g in range(8):
            idx = _COL_IDX[g] if g < 4 else _DIAG_IDX[g - 4]
            a, b, c, d = (v[i] for i in idx)
            x, y = m_words[s[2 * g]], m_words[s[2 * g + 1]]
            a = (a + b + x) & 0xFFFFFFFF
            d = _rotr(d ^ a, 16)
            c = (c + d) & 0xFFFFFFFF
            b = _rotr(b ^ c, 12)
            a = (a + b + y) & 0xFFFFFFFF
            d = _rotr(d ^ a, 8)
            c = (c + d) & 0xFFFFFFFF
            b = _rotr(b ^ c, 7)
            for i, val in zip(idx, (a, b, c, d)):
                v[i] = val
    return [(_H0[i] ^ v[i] ^ v[i + 8]) & 0xFFFFFFFF for i in range(8)]


def blake2s_digest(data: bytes) -> bytes:
    assert len(data) <= 64
    t = len(data)
    padded = data + b"\x00" * (64 - len(data))
    m = [int.from_bytes(padded[4 * i:4 * i + 4], "little") for i in range(16)]
    out = blake2s_compress(m, t)
    return b"".join(w.to_bytes(4, "little") for w in out)


# --------------------------------------------------------------------------
# Column layout
# --------------------------------------------------------------------------

class _C:
    V = 0                       # 16 x 32 state bits
    M = 512                     # 16 x 32 message bits
    GA1 = 1024                  # per-G materialized words: 8 G x 4 words
    # layout: for g in 0..7: A1, C1, A2, C2 (each 32 bits)
    CARS = GA1 + 8 * 4 * 32     # per-G carries: 2+1+2+1 = 6 bits x 8
    DIGB = CARS + 48            # digest bits (defined at the output row)
    SIB = DIGB + 256            # sibling bits (on chain rows)
    PBIT = SIB + 256            # path bit (on chain rows)


NUM_WITNESS = _C.PBIT + 1

# const columns: 10 round selectors, s_absorb_leaf, s_absorb_node, s_out,
# s_mcarry (M carried rows 0..10), s_dcarry (DIGB carried row 10),
# s_chain (row 11 of non-final compressions)
K_RND = 0
K_AL, K_AN, K_SO, K_MC, K_DC, K_SH = 10, 11, 12, 13, 14, 15
NUM_CONST = 16


@dataclasses.dataclass(frozen=True)
class PathGeometry:
    depth: int      # node compressions above the leaf

    @property
    def compressions(self) -> int:
        return self.depth + 1

    @property
    def rows(self) -> int:
        return self.compressions * ROWS_PER_COMPRESSION

    @property
    def log_n(self) -> int:
        n = 16
        while n < self.rows:
            n *= 2
        return (n - 1).bit_length()

    @property
    def n(self) -> int:
        return 1 << self.log_n


def _xor(alg, a, b):
    return alg.sub(alg.add(a, b), alg.mul_int(alg.mul(a, b), 2))


def _xor_const(alg, a, bit: int):
    return alg.add_int(alg.mul_int(a, P - 1), 1) if bit else a


def _one_minus(alg, x):
    return alg.add_int(alg.mul_int(x, P - 1), 1)


def _bits_of(words: Sequence[int]) -> np.ndarray:
    """(len(words), 32) 0/1 bits, bit z of word i at [i, z]."""
    w = np.asarray(words, dtype=np.uint64)
    return ((w[..., None] >> np.arange(32, dtype=np.uint64)) & 1).astype(
        np.uint8)


def _vinit_bits(t: int) -> np.ndarray:
    v = list(_H0) + list(_IV)
    v[12] ^= t
    v[14] ^= 0xFFFFFFFF
    return _bits_of(v).reshape(-1)


_SIGMA_NP = np.array(_SIGMA, dtype=np.int64)          # (10, 16)
_H0_BITS = _bits_of(_H0)                               # (8, 32)


def _xor_bits(alg, bits, field_bits):
    """bits ^ (a constant 0/1 tensor): bits * (1 - 2 c) + c."""
    return alg.add(alg.mul(bits, gl.sub(gl.ones((), field_bits.device),
                                        gl.add(field_bits, field_bits))),
                   field_bits)


def _rot(x, s: int):
    """Bit z of the result = bit (z + s) % 32 of x (bits on axis -2)."""
    return torch.roll(x, -s, dims=-2)


def _path_gates_stacked(alg, w, w_next, c) -> List:
    """The gate list of `path_ir`, each family one stacked tensor."""
    dev = w[0].device
    s_rnd = col_stack(c, K_RND, NUM_ROUNDS)
    s_r = gl.sum_axis(s_rnd, axis=0)
    s_al, s_an, s_o = c[K_AL], c[K_AN], c[K_SO]
    s_mc, s_dc, s_h = c[K_MC], c[K_DC], c[K_SH]
    ALL = col_stack(w, 0, NUM_WITNESS)
    n = ALL.shape[-1]
    out = rows_of(alg.sub(alg.mul(ALL, ALL), ALL))        # booleanity
    V = ALL[_C.V:_C.V + 512].reshape(16, 32, n)
    Mb = ALL[_C.M:_C.M + 512]
    GA = ALL[_C.GA1:_C.CARS].reshape(8, 4, 32, n)
    CARS = ALL[_C.CARS:_C.CARS + 48].reshape(8, 6, n)
    DIGB = ALL[_C.DIGB:_C.DIGB + 256].reshape(8, 32, n)
    SIB = ALL[_C.SIB:_C.SIB + 256].reshape(8, 32, n)
    pbit = ALL[_C.PBIT]
    M_n = col_stack(w_next, _C.M, 512)
    out += rows_of(alg.mul(s_mc, alg.sub(M_n, Mb)))
    out += rows_of(alg.mul(s_dc, alg.sub(col_stack(w_next, _C.DIGB, 256),
                                         DIGB.reshape(256, n))))
    for sel, t in ((s_al, 40), (s_an, 64)):
        init = gl.from_int(_vinit_bits(t), dev).reshape(512, 1)
        out += rows_of(alg.mul(sel, _xor_bits(alg, V.reshape(512, n),
                                              init)))
    out += rows_of(alg.mul(s_al, Mb[320:512]))             # leaf padding

    # the round's message words x, y of every G: sum_r s_r * M[sigma_r]
    Mw = words_of_bits(alg, Mb.reshape(16, 32, n))
    idx = torch.from_numpy(_SIGMA_NP.reshape(-1)).to(dev)
    msw = gl.sum_axis(alg.mul(Mw.index_select(0, idx).reshape(
        NUM_ROUNDS, 16, n), s_rnd.reshape(NUM_ROUNDS, 1, n)), axis=0)

    def xor(a, b):
        return alg.sub(alg.add(a, b), alg.mul_int(alg.mul(a, b), 2))

    def half(ga, cars, pa, pb, pc, pd, x, y):
        """Four G functions on bit blocks (4, 32, n): their 4 x 4 word
        equations and the state words (a, b, c, d) they leave."""
        A1, C1, A2, C2 = ga[:, 0], ga[:, 1], ga[:, 2], ga[:, 3]
        dp = _rot(xor(pd, A1), 16)
        bp = _rot(xor(pb, C1), 12)
        dpp = _rot(xor(dp, A2), 8)
        bpp = _rot(xor(bp, C2), 7)
        word = lambda b: words_of_bits(alg, b)           # noqa: E731
        ca1 = alg.add(cars[:, 0], alg.mul_int(cars[:, 1], 2))
        ca2 = alg.add(cars[:, 3], alg.mul_int(cars[:, 4], 2))
        wa1, wc1 = word(A1), word(C1)
        eqs = [
            alg.sub(alg.add(wa1, alg.mul_int(ca1, 1 << 32)),
                    alg.add(alg.add(word(pa), word(pb)), x)),
            alg.sub(alg.add(wc1, alg.mul_int(cars[:, 2], 1 << 32)),
                    alg.add(word(pc), word(dp))),
            alg.sub(alg.add(word(A2), alg.mul_int(ca2, 1 << 32)),
                    alg.add(alg.add(wa1, word(bp)), y)),
            alg.sub(alg.add(word(C2), alg.mul_int(cars[:, 5], 1 << 32)),
                    alg.add(wc1, word(dpp)))]
        return (rows_of(alg.mul(s_r, torch.stack(eqs, dim=1))),
                (A2, bpp, C2, dpp))

    # column step: G g on words (g, 4 + g, 8 + g, 12 + g)
    eqs, (pa, pb, pc, pd) = half(GA[:4], CARS[:4], V[0:4], V[4:8], V[8:12],
                                 V[12:16], msw[0:8:2], msw[1:8:2])
    out += eqs
    # diagonal step: G 4 + j on words (j, 4 + (j+1)%4, 8 + (j+2)%4,
    # 12 + (j+3)%4)
    eqs, (fa, fb, fc, fd) = half(
        GA[4:], CARS[4:], pa, torch.roll(pb, -1, 0), torch.roll(pc, -2, 0),
        torch.roll(pd, -3, 0), msw[8::2], msw[9::2])
    out += eqs
    # state transition into the next row
    post = torch.cat([fa, torch.roll(fb, 1, 0), torch.roll(fc, 2, 0),
                      torch.roll(fd, 3, 0)])
    V_n = col_stack(w_next, _C.V, 512).reshape(16, 32, n)
    out += rows_of(alg.mul(s_r, alg.sub(V_n, post)))
    # digest at the output row: dig = H0 ^ v ^ v8
    h0 = gl.from_int(_H0_BITS, dev).reshape(8, 32, 1)
    out += rows_of(alg.mul(s_o, alg.sub(
        DIGB, _xor_bits(alg, xor(V[:8], V[8:]), h0))))
    # chain row: next absorb's message = pbit ? (sib || dig) : (dig || sib)
    npb = alg.add_int(alg.mul_int(pbit, P - 1), 1)
    lo = alg.add(alg.mul(pbit, SIB), alg.mul(npb, DIGB))
    hi = alg.add(alg.mul(pbit, DIGB), alg.mul(npb, SIB))
    M_n = M_n.reshape(16, 32, n)
    out += rows_of(alg.mul(s_h, torch.stack(
        [alg.sub(M_n[:8], lo), alg.sub(M_n[8:], hi)], dim=2)))
    return out


def path_ir(geo: PathGeometry) -> pk.PlonkishIR:
    n = geo.n

    def eval_gates(alg, w, w_next, c):
        if stacks(alg):
            return _path_gates_stacked(alg, w, w_next, c)
        out = []
        s_rnd = [c[K_RND + r] for r in range(NUM_ROUNDS)]
        s_r = s_rnd[0]
        for r in range(1, NUM_ROUNDS):
            s_r = alg.add(s_r, s_rnd[r])
        s_al, s_an, s_o = c[K_AL], c[K_AN], c[K_SO]
        s_mc, s_dc, s_h = c[K_MC], c[K_DC], c[K_SH]

        def vb(word, z):
            return w[_C.V + 32 * word + z]

        def vb_n(word, z):
            return w_next[_C.V + 32 * word + z]

        def mb(word, z):
            return w[_C.M + 32 * word + z]

        def gword(g, slot, z):   # slot: 0=A1 1=C1 2=A2 3=C2
            return w[_C.GA1 + 32 * (4 * g + slot) + z]

        def val(bit_fn, *pre):
            acc = None
            for z in range(32):
                t = alg.mul_int(bit_fn(*pre, z), 1 << z)
                acc = t if acc is None else alg.add(acc, t)
            return acc

        # booleanity: state, message, G words, carries, DIGB, SIB, PBIT
        for col in (list(range(_C.V, _C.V + 512))
                    + list(range(_C.M, _C.M + 512))
                    + list(range(_C.GA1, _C.CARS + 48))
                    + list(range(_C.DIGB, _C.DIGB + 256))
                    + list(range(_C.SIB, _C.SIB + 256))
                    + [_C.PBIT]):
            b = w[col]
            out.append(alg.sub(alg.mul(b, b), b))

        # M and DIGB carried
        for z in range(512):
            out.append(alg.mul(s_mc, alg.sub(w_next[_C.M + z], w[_C.M + z])))
        for z in range(256):
            out.append(alg.mul(s_dc, alg.sub(w_next[_C.DIGB + z],
                                             w[_C.DIGB + z])))

        # v initialization at absorb rows (leaf: t=40, node: t=64)
        def vinit_bits(t):
            v = list(_H0) + list(_IV)
            v[12] ^= t
            v[14] ^= 0xFFFFFFFF
            return v

        for (sel, t) in ((s_al, 40), (s_an, 64)):
            init = vinit_bits(t)
            for word in range(16):
                for z in range(32):
                    bit = (init[word] >> z) & 1
                    target = _xor_const(alg, vb(word, z), bit)
                    out.append(alg.mul(sel, target))
        # leaf padding: message bytes 40..63 are zero
        for z in range(320, 512):
            out.append(alg.mul(s_al, w[_C.M + z]))

        # one blake2s round per round row
        def m_sel(slot_idx, z):
            """bit z of the message word sigma_r(slot_idx) under the active
            round selector."""
            acc = None
            for r in range(NUM_ROUNDS):
                t = alg.mul(s_rnd[r], mb(_SIGMA[r][slot_idx], z))
                acc = t if acc is None else alg.add(acc, t)
            return acc

        # expressions for the state entering the diagonal half
        def col_g_exprs(g):
            a_idx, b_idx, c_idx, d_idx = _COL_IDX[g]
            A1 = lambda z: gword(g, 0, z)
            C1 = lambda z: gword(g, 1, z)
            A2 = lambda z: gword(g, 2, z)
            C2 = lambda z: gword(g, 3, z)
            dp = lambda z: _xor(alg, vb(d_idx, (z + 16) % 32),
                                A1((z + 16) % 32))
            bp = lambda z: _xor(alg, vb(b_idx, (z + 12) % 32),
                                C1((z + 12) % 32))
            dpp = lambda z: _xor(alg, dp((z + 8) % 32), A2((z + 8) % 32))
            bpp = lambda z: _xor(alg, bp((z + 7) % 32), C2((z + 7) % 32))
            return A1, C1, A2, C2, dp, bp, dpp, bpp

        car = lambda g, k: w[_C.CARS + 6 * g + k]
        post: Dict[int, object] = {}   # word index -> (bit_fn)
        for g in range(4):
            a_idx, b_idx, c_idx, d_idx = _COL_IDX[g]
            A1, C1, A2, C2, dp, bp, dpp, bpp = col_g_exprs(g)
            x = val(m_sel, 2 * g)
            y = val(m_sel, 2 * g + 1)
            ca1 = alg.add(car(g, 0), alg.mul_int(car(g, 1), 2))
            ca2 = alg.add(car(g, 3), alg.mul_int(car(g, 4), 2))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(A1), alg.mul_int(ca1, 1 << 32)),
                alg.add(alg.add(val(vb, a_idx), val(vb, b_idx)), x))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(C1), alg.mul_int(car(g, 2), 1 << 32)),
                alg.add(val(vb, c_idx), val(dp)))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(A2), alg.mul_int(ca2, 1 << 32)),
                alg.add(alg.add(val(A1), val(bp)), y))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(C2), alg.mul_int(car(g, 5), 1 << 32)),
                alg.add(val(C1), val(dpp)))))
            post[a_idx] = A2
            post[b_idx] = bpp
            post[c_idx] = C2
            post[d_idx] = dpp
        for gd in range(4):
            g = 4 + gd
            a_idx, b_idx, c_idx, d_idx = _DIAG_IDX[gd]
            A1 = lambda z, g=g: gword(g, 0, z)
            C1 = lambda z, g=g: gword(g, 1, z)
            A2 = lambda z, g=g: gword(g, 2, z)
            C2 = lambda z, g=g: gword(g, 3, z)
            pa, pb, pc, pd = (post[a_idx], post[b_idx], post[c_idx],
                              post[d_idx])
            dp = lambda z, pd=pd, A1=A1: _xor(alg, pd((z + 16) % 32),
                                              A1((z + 16) % 32))
            bp = lambda z, pb=pb, C1=C1: _xor(alg, pb((z + 12) % 32),
                                              C1((z + 12) % 32))
            dpp = lambda z, dp=dp, A2=A2: _xor(alg, dp((z + 8) % 32),
                                               A2((z + 8) % 32))
            bpp = lambda z, bp=bp, C2=C2: _xor(alg, bp((z + 7) % 32),
                                               C2((z + 7) % 32))
            x = val(m_sel, 2 * g)
            y = val(m_sel, 2 * g + 1)
            ca1 = alg.add(car(g, 0), alg.mul_int(car(g, 1), 2))
            ca2 = alg.add(car(g, 3), alg.mul_int(car(g, 4), 2))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(A1), alg.mul_int(ca1, 1 << 32)),
                alg.add(alg.add(val(pa), val(pb)), x))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(C1), alg.mul_int(car(g, 2), 1 << 32)),
                alg.add(val(pc), val(dp)))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(A2), alg.mul_int(ca2, 1 << 32)),
                alg.add(alg.add(val(A1), val(bp)), y))))
            out.append(alg.mul(s_r, alg.sub(
                alg.add(val(C2), alg.mul_int(car(g, 5), 1 << 32)),
                alg.add(val(C1), val(dpp)))))
            # the new state for the involved words
            post[a_idx] = A2
            post[b_idx] = bpp
            post[c_idx] = C2
            post[d_idx] = dpp
        # state transition into the next row
        for word in range(16):
            fn = post[word]
            for z in range(32):
                out.append(alg.mul(s_r, alg.sub(vb_n(word, z), fn(z))))

        # digest at the output row: dig = H0 ^ v ^ v8
        for word in range(8):
            for z in range(32):
                bit_h = (_H0[word] >> z) & 1
                expr = _xor(alg, vb(word, z), vb(word + 8, z))
                expr = _xor_const(alg, expr, bit_h)
                out.append(alg.mul(s_o, alg.sub(w[_C.DIGB + 32 * word + z],
                                                expr)))

        # chain row: next absorb's message = pbit ? (sib || dig) swap
        pbit = w[_C.PBIT]
        for word in range(8):
            for z in range(32):
                dig = w[_C.DIGB + 32 * word + z]
                sib = w[_C.SIB + 32 * word + z]
                lo = alg.add(alg.mul(pbit, sib),
                             alg.mul(_one_minus(alg, pbit), dig))
                hi = alg.add(alg.mul(pbit, dig),
                             alg.mul(_one_minus(alg, pbit), sib))
                out.append(alg.mul(s_h, alg.sub(
                    w_next[_C.M + 32 * word + z], lo)))
                out.append(alg.mul(s_h, alg.sub(
                    w_next[_C.M + 32 * (word + 8) + z], hi)))
        return out

    n_constraints = (
        (512 + 512 + 8 * 4 * 32 + 48 + 256 + 256 + 1)  # booleanity
        + 512 + 256                                     # M/DIGB carries
        + 2 * 512 + 192                                 # v init + leaf pad
        + 8 * 4                                         # G word equations
        + 512                                           # state transition
        + 256                                           # digest definition
        + 512)                                          # chain selection

    # public inputs: leaf message bits (320), path bits per level, root bits
    last_out_row = geo.depth * ROWS_PER_COMPRESSION + NUM_ROUNDS
    pis: List[Tuple[int, int]] = []
    for z in range(320):
        pis.append((_C.M + z, 0))
    for k in range(geo.depth):
        pis.append((_C.PBIT, k * ROWS_PER_COMPRESSION + 11))
    for z in range(256):
        pis.append((_C.DIGB + z, last_out_row))

    return pk.PlonkishIR(
        log_n=geo.log_n, num_witness=NUM_WITNESS, num_const=NUM_CONST,
        gate_degree=6, num_gate_constraints=n_constraints,
        eval_gates=eval_gates, copy_chunk=4,
        public_input_cells=tuple(pis))


def _const_rows(geo: PathGeometry) -> np.ndarray:
    n = geo.n
    rows = np.zeros((n, NUM_CONST), dtype=np.uint64)
    for k in range(geo.compressions):
        base = k * ROWS_PER_COMPRESSION
        for r in range(NUM_ROUNDS):
            rows[base + r, K_RND + r] = 1
        rows[base, K_AL if k == 0 else K_AN] = 1
        rows[base + NUM_ROUNDS, K_SO] = 1
        rows[base + NUM_ROUNDS, K_DC] = 1  # DIGB carried 10 -> 11
        for r in range(NUM_ROUNDS + 1):
            rows[base + r, K_MC] = 1       # M carried 0..10 -> 1..11
        if k < geo.compressions - 1:
            rows[base + 11, K_SH] = 1      # chain into the next absorb
    return rows


def path_setup(ir: pk.PlonkishIR, geo: PathGeometry,
               cfg: pk.PlonkishConfig, device=None) -> pk.PlonkishSetup:
    """`device=None` means the CUDA card (raises where there is none)."""
    return pk.build_setup(ir, _const_rows(geo).T, pk.CopyWiring.identity(),
                          cfg, device=device)


# --------------------------------------------------------------------------
# Witness generation
# --------------------------------------------------------------------------

def _word_bits(v: int) -> List[int]:
    return [(int(v) >> z) & 1 for z in range(32)]


def _bytes_to_words(data: bytes) -> List[int]:
    padded = data + b"\x00" * (64 - len(data))
    return [int.from_bytes(padded[4 * i:4 * i + 4], "little")
            for i in range(16)]


@dataclasses.dataclass
class PathInstanceInputs:
    """One Merkle opening: the leaf preimage, path bits (LSB = level 0),
    and the sibling hashes bottom-up."""
    leaf_preimage: bytes          # 40 bytes: enum_index_u64_be || value_32
    path_bits: List[int]          # depth entries
    siblings: List[bytes]         # depth 32-byte hashes


def _compression_trace(m_words: List[int], t: int):
    """The words a compression leaves in its rows: the state entering each
    round and after the last (11, 16), the four materialized words of each
    G function per round (10, 8, 4), their six carry bits (10, 8, 6), and
    the digest (8,)."""
    v = list(_H0) + list(_IV)
    v[12] ^= t
    v[14] ^= 0xFFFFFFFF
    states, gwords, cars = [], [], []
    for r in range(NUM_ROUNDS):
        states.append(list(v))
        s = _SIGMA[r]
        gw, cb = [], []
        for g in range(8):
            idx = _COL_IDX[g] if g < 4 else _DIAG_IDX[g - 4]
            a, b, c, d = (v[i] for i in idx)
            x, y = m_words[s[2 * g]], m_words[s[2 * g + 1]]
            t1 = a + b + x
            a1 = t1 & 0xFFFFFFFF
            ca1 = t1 >> 32
            d1 = _rotr(d ^ a1, 16)
            t2 = c + d1
            c1 = t2 & 0xFFFFFFFF
            cc1 = t2 >> 32
            b1 = _rotr(b ^ c1, 12)
            t3 = a1 + b1 + y
            a2 = t3 & 0xFFFFFFFF
            ca2 = t3 >> 32
            d2 = _rotr(d1 ^ a2, 8)
            t4 = c1 + d2
            c2 = t4 & 0xFFFFFFFF
            cc2 = t4 >> 32
            b2 = _rotr(b1 ^ c2, 7)
            gw.append((a1, c1, a2, c2))
            cb.append((ca1 & 1, ca1 >> 1, cc1, ca2 & 1, ca2 >> 1, cc2))
            for i, wv in zip(idx, (a2, b2, c2, d2)):
                v[i] = wv
        gwords.append(gw)
        cars.append(cb)
    states.append(list(v))
    dig = [(_H0[i] ^ v[i] ^ v[i + 8]) & 0xFFFFFFFF for i in range(8)]
    return states, gwords, cars, dig


def path_witness(ir: pk.PlonkishIR, geo: PathGeometry,
                 inst: PathInstanceInputs, device=None) -> gl.GF:
    """`device=None` means the CUDA card (raises where there is none)."""
    device = gl.resolve_device(device)
    assert len(inst.path_bits) == geo.depth
    assert len(inst.siblings) == geo.depth
    K, D = geo.compressions, geo.depth
    msgs, states, gwords, cars, digs = [], [], [], [], []
    data, t = inst.leaf_preimage, 40
    for k in range(K):
        m_words = _bytes_to_words(data)
        st, gw, cb, dig = _compression_trace(m_words, t)
        msgs.append(m_words)
        states.append(st)
        gwords.append(gw)
        cars.append(cb)
        digs.append(dig)
        if k < D:
            dig_bytes = b"".join(w.to_bytes(4, "little") for w in dig)
            sib = inst.siblings[k]
            data = ((sib + dig_bytes) if int(inst.path_bits[k]) & 1
                    else (dig_bytes + sib))
            t = 64
    W = np.zeros((ir.num_witness, geo.n), dtype=np.uint8)
    blk = W[:, :K * ROWS_PER_COMPRESSION].reshape(
        ir.num_witness, K, ROWS_PER_COMPRESSION)
    v_bits = _bits_of(states).reshape(K, NUM_ROUNDS + 1, 512)
    blk[_C.V:_C.V + 512, :, :NUM_ROUNDS + 1] = v_bits.transpose(2, 0, 1)
    m_bits = _bits_of(msgs).reshape(K, 512)
    blk[_C.M:_C.M + 512, :, :NUM_ROUNDS + 2] = m_bits.T[:, :, None]
    g_bits = _bits_of(gwords).reshape(K, NUM_ROUNDS, 1024)
    blk[_C.GA1:_C.CARS, :, :NUM_ROUNDS] = g_bits.transpose(2, 0, 1)
    c_bits = np.asarray(cars, dtype=np.uint8).reshape(K, NUM_ROUNDS, 48)
    blk[_C.CARS:_C.CARS + 48, :, :NUM_ROUNDS] = c_bits.transpose(2, 0, 1)
    d_bits = _bits_of(digs).reshape(K, 256)
    blk[_C.DIGB:_C.DIGB + 256, :, NUM_ROUNDS:NUM_ROUNDS + 2] = \
        d_bits.T[:, :, None]
    if D:
        sib_words = [[int.from_bytes(s[4 * i:4 * i + 4], "little")
                      for i in range(8)] for s in inst.siblings]
        blk[_C.SIB:_C.SIB + 256, :D, 11] = _bits_of(sib_words).reshape(
            D, 256).T
        blk[_C.PBIT, :D, 11] = [int(b) & 1 for b in inst.path_bits]
    return torch.from_numpy(W).to(device).to(torch.int64)


def expected_public_inputs(geo: PathGeometry, inst: PathInstanceInputs
                           ) -> List[int]:
    out: List[int] = []
    leaf_words = _bytes_to_words(inst.leaf_preimage)
    for word in range(10):
        out += _word_bits(leaf_words[word])
    out += [int(b) & 1 for b in inst.path_bits]
    # replay the path for the root
    dig = blake2s_digest(inst.leaf_preimage)
    for k in range(geo.depth):
        sib = inst.siblings[k]
        data = (sib + dig) if (int(inst.path_bits[k]) & 1) else (dig + sib)
        dig = blake2s_digest(data)
    for word in range(8):
        out += _word_bits(int.from_bytes(dig[4 * word:4 * word + 4],
                                         "little"))
    return out


def root_bytes(geo: PathGeometry, pis: Sequence[int]) -> bytes:
    bits = [int(v) for v in pis[-256:]]
    out = b""
    for word in range(8):
        w = sum(bits[32 * word + z] << z for z in range(32))
        out += w.to_bytes(4, "little")
    return out
