"""FRI low-degree test: batched folding on device, Merkle-committed layers.

Counterpart of the JAX package's `prover/fri.py`. Folding is radix-2 over the extension field: each round is a handful
of field kernels over the whole codeword; layer commitments use pair-leaves
so a single opening serves the butterfly.

Layer layout. codeword_0 (the DEEP composition, size N0 on coset g·<w>) is
NOT committed here — its queried values are recomputed by the verifier from
the trace/quotient openings. Layers 1..R-1 are committed with leaf
l ∈ [0, N_r/2) = [c0(a), c1(a), c0(b), c1(b)] for a = f(d_l), b = f(-d_l).
The final layer is sent as coefficients; the verifier checks its degree and
evaluates it directly. A hash backend (prover/hash_backend.Bn254Backend, the
compression-for-wrapper mode) replaces the layer trees' hasher and the cap
absorption; its trees are built on the codeword's device too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops.goldilocks import GF, GF2, P
from ..utils import field_int as fi
from ..utils import tracing
from .transcript import Transcript

INV2 = pow(2, P - 2, P)


@dataclasses.dataclass(frozen=True)
class FriConfig:
    folding_rounds: int  # number of radix-2 folds (N0 -> N0 >> folding_rounds)
    cap_size: int = 16
    num_queries: int = 40
    lde_factor: int = 2  # rate; final poly degree bound = N_final / lde_factor


@dataclasses.dataclass
class FriLayerOpening:
    leaves: np.ndarray  # (q, 4) object ints [a0, a1, b0, b1]
    paths: np.ndarray  # (q, depth, 4) ints


@dataclasses.dataclass
class FriProof:
    caps: List[np.ndarray]  # per committed layer: (cap, 4) ints
    final_poly: List[Tuple[int, int]]  # ext coefficients, low-to-high
    openings: List[FriLayerOpening]  # per committed layer
    query_positions: np.ndarray  # (q,) in [0, N0)


def _fold_eager(cw: GF2, alpha: GF2, inv_domain: GF) -> GF2:
    """One radix-2 fold: new(y) = f_e(y) + alpha * f_o(y), y = x^2."""
    n = cw.shape[0]
    h = n // 2
    a, b = cw[:h], cw[h:]
    inv2 = gl.scalar_like(INV2, cw.c0)
    e = GF2(gl.mul(gl.add(a.c0, b.c0), inv2), gl.mul(gl.add(a.c1, b.c1), inv2))
    o = GF2(gl.mul(gl.sub(a.c0, b.c0), inv2), gl.mul(gl.sub(a.c1, b.c1), inv2))
    o = gl.ext_mul_base(o, inv_domain)
    return gl.ext_add(e, gl.ext_mul(alpha, o))


def _inv_domain_half(n: int, shift: int, device=None) -> GF:
    """[1/d_0 .. 1/d_{n/2-1}] for d_i = shift * w^i, w of order n — a shape
    constant, cached device-resident."""
    log_n = n.bit_length() - 1
    w_inv = pow(gl.primitive_root_of_unity(log_n), P - 2, P)
    s_inv = pow(shift, P - 2, P)
    return gl.powers_dev_cached(w_inv, n // 2, mult=s_inv, device=device)


def _pair_leaf_rows(cw: GF2) -> GF:
    """(n,) ext codeword -> (n/2, 4) leaf rows [a0, a1, b0, b1]."""
    n = cw.shape[0]
    h = n // 2
    a, b = cw[:h], cw[h:]
    return gl.stack([a.c0, a.c1, b.c0, b.c1], axis=-1)


def fri_prove(codeword: GF2, shift: int, tr: Transcript,
              cfg: FriConfig, backend=None) -> FriProof:
    """`backend` switches the layer-tree hasher and the cap absorption to
    another hash backend; None keeps Goldilocks Poseidon2."""
    n0 = codeword.shape[0]
    device = codeword.device
    codewords = [codeword]
    trees: List[mk.MerkleTree] = []

    cur = codeword
    cur_shift = shift
    with tracing.span("fri_folds"):
        for r in range(cfg.folding_rounds):
            alpha = tr.challenge_ext()
            inv_dom = _inv_domain_half(cur.shape[0], cur_shift, device)
            cur = _fold_eager(cur, alpha, inv_dom)
            cur_shift = (cur_shift * cur_shift) % P
            codewords.append(cur)
            if r < cfg.folding_rounds - 1:
                # commit the folded layer (pair leaves for the NEXT fold)
                rows = _pair_leaf_rows(cur)
                cap_sz = min(cfg.cap_size, rows.shape[0])
                if backend is not None:
                    tree = backend.commit_rows(rows.t(), cap_sz)
                    tr.absorb_fr(tree.cap)
                else:
                    tree = mk.commit(rows, cap_sz)
                    tr.absorb_gf_device(tree.cap)
                trees.append(tree)

    with tracing.span("fri_final"):
        # final polynomial from the last codeword (coset intt + unscale)
        final_cw = codewords[-1]
        n_f = final_cw.shape[0]
        unscale = gl.powers_dev_cached(pow(cur_shift, P - 2, P), n_f,
                                       device=device)
        c0 = gl.to_u64(gl.mul(nt.intt(final_cw.c0), unscale))
        c1 = gl.to_u64(gl.mul(nt.intt(final_cw.c1), unscale))
        final_coeffs = [(int(a), int(b)) for a, b in zip(c0, c1)]
        tr.absorb_ints([v for pair in final_coeffs for v in pair])
        if backend is not None:
            caps_np = [np.asarray(tree.cap, dtype=object) for tree in trees]
        else:
            caps_np = [gl.to_u64(tree.cap) for tree in trees]
        positions = tr.query_indices(cfg.num_queries, n0)

    with tracing.span("fri_openings"):
        openings: List[FriLayerOpening] = []
        for r in range(1, cfg.folding_rounds):
            cw_r = codewords[r]
            n_r = cw_r.shape[0]
            pos_r = positions % np.uint32(n_r)
            leaf_idx = pos_r % np.uint32(n_r // 2)
            leaves = gl.take(_pair_leaf_rows(cw_r), leaf_idx, axis=0)
            if backend is not None:
                paths = backend.open(trees[r - 1], leaf_idx)
            else:
                paths = gl.to_u64(mk.open_indices(trees[r - 1], leaf_idx))
            openings.append(FriLayerOpening(gl.to_ints(leaves), paths))

    return FriProof(caps=caps_np, final_poly=final_coeffs, openings=openings,
                    query_positions=positions)


def fri_verify(proof: FriProof, n0: int, shift: int, tr: Transcript,
               cfg: FriConfig, codeword0_at, backend=None) -> bool:
    """Verify a FRI proof.

    `codeword0_at(position) -> (c0, c1)` returns the layer-0 (DEEP) value at
    an LDE index; the verifier derives it from the trace/quotient openings.
    The transcript must be in the state the prover's was at fri_prove entry.
    """
    device = tr.device
    # 1. replay transcript: alphas, caps, final poly, positions
    alphas = []
    for r in range(cfg.folding_rounds):
        alphas.append(tr.challenge_ext_ints())
        if r < cfg.folding_rounds - 1:
            flat = [int(v) for v in
                    np.asarray(proof.caps[r], dtype=object).ravel()]
            if backend is not None:
                tr.absorb_fr(flat)
            else:
                tr.absorb_ints(flat)
    tr.absorb_ints([v for pair in proof.final_poly for v in pair])
    positions = tr.query_indices(cfg.num_queries, n0)
    if not np.array_equal(positions, proof.query_positions):
        return False

    # 2. degree check on the final polynomial
    n_f = n0 >> cfg.folding_rounds
    if len(proof.final_poly) != n_f:
        return False
    deg_bound = n_f // cfg.lde_factor
    if any(c != (0, 0) for c in proof.final_poly[deg_bound:]):
        return False

    # 3. batch-verify Merkle paths of committed layers
    for r in range(1, cfg.folding_rounds):
        n_r = n0 >> r
        pos_r = positions % np.uint32(n_r)
        leaf_idx = pos_r % np.uint32(n_r // 2)
        op = proof.openings[r - 1]
        if backend is not None:
            leaves_t = gl.from_int(np.asarray(op.leaves, dtype=object),
                                   backend.device).t()
            if not backend.verify_paths(
                    backend.hash_rows(leaves_t), [int(v) for v in leaf_idx],
                    np.asarray(op.paths, dtype=object),
                    [int(v) for v in
                     np.asarray(proof.caps[r - 1], dtype=object).ravel()]):
                return False
            continue
        leaves_gf = gl.from_int(np.asarray(op.leaves, dtype=object), device)
        paths_gf = gl.from_int(np.asarray(op.paths, dtype=object), device)
        cap_gf = gl.from_int(np.asarray(proof.caps[r - 1], dtype=object),
                             device)
        ok = mk.verify_paths(mk.hash_leaves(leaves_gf), leaf_idx, paths_gf,
                             cap_gf, n_leaves=n_r // 2,
                             cap_size=min(cfg.cap_size, n_r // 2))
        if not bool(ok.all()):
            return False

    # 4. fold-consistency per query (exact ints)
    log_n0 = n0.bit_length() - 1
    w_r = [gl.primitive_root_of_unity(log_n0 - r)
           for r in range(cfg.folding_rounds + 1)]
    shifts = [shift]
    for _ in range(cfg.folding_rounds):
        shifts.append((shifts[-1] * shifts[-1]) % P)

    for qi, p0 in enumerate(positions):
        p0 = int(p0)
        # layer 0 values from the callback
        h0 = n0 // 2
        j = p0 % h0
        a = codeword0_at(j)
        b = codeword0_at(j + h0)
        value = None
        for r in range(cfg.folding_rounds):
            n_r = n0 >> r
            h_r = n_r // 2
            if r > 0:
                op = proof.openings[r - 1]
                leaf = [int(v) for v in op.leaves[qi]]
                a_leaf = (leaf[0], leaf[1])
                b_leaf = (leaf[2], leaf[3])
                # consistency: the previous folded value must equal the
                # component of this leaf at our position
                expected = a_leaf if j < h_r else b_leaf
                if value != expected:
                    return False
                a, b = a_leaf, b_leaf
                j = j % h_r
            # fold a, b at index j of layer r
            d = (shifts[r] * pow(w_r[r], j, P)) % P
            e = fi.escale(fi.eadd(a, b), INV2)
            o = fi.escale(fi.emul(fi.esub(a, b), (fi.finv(d), 0)), INV2)
            value = fi.eadd(e, fi.emul(alphas[r], o))
        # final check: value == final_poly(x) at x = shifts[R] * w_R^j
        x = (shifts[cfg.folding_rounds]
             * pow(w_r[cfg.folding_rounds], j % n_f, P)) % P
        got = fi.eval_poly_ext(proof.final_poly, (x, 0))
        if got != value:
            return False
    return True
