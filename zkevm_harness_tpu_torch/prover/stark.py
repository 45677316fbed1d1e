"""Generic AIR STARK prover/verifier over Goldilocks (Poseidon2 + FRI).

Counterpart of the JAX package's `prover/stark.py`: the engine for a generic
AIR (transition + boundary constraints), with the same transcript order,
proof layout and serialisation. The heavy phases are batched field kernels
over whole columns and domains on `device` (trace LDE, Merkle commitments,
constraint evaluation over the LDE coset, quotient split and commitment,
DEEP composition, FRI folds); transcript and query logic run on the host
between them.

Constraints are written once against an `Algebra` and evaluated both on the
device (base-field tensors over a whole coset) and on the host (exact ext
ints at the OOD point).

Entry points take `device`: `None` means the CUDA card (raises where there
is none); `"cpu"` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops.goldilocks import GF, GF2, P
from ..utils import field_int as fi
from ..utils import tracing
from .fri import FriConfig, FriProof, fri_prove, fri_verify
from .transcript import Transcript


# ---------------------------------------------------------------------------
# Algebra adapters: one constraint definition, two evaluation modes
# ---------------------------------------------------------------------------

class DeviceAlgebra:
    """Constraints over base-field tensors (a whole coset at once).

    `stacks_tiles`: a circuit built from repeated column tiles (the sponge
    tiles of circuits/narrow_region.py and the RAM permutation) may evaluate
    all its tiles at once, each lane stacked into one (tiles, n) tensor, so
    that an operation is one launch for every tile; the constraint values and
    their order are those of the tile-by-tile loop. The host algebras
    evaluate tile by tile."""

    stacks_tiles = True

    def __init__(self):
        self._consts = {}  # (value, device) -> 0-d field tensor

    def _const(self, c: int, like):
        key = (c % P, like.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = gl.scalar_like(c, like)
        return t

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_int(self, a, c: int):
        return gl.mul(a, self._const(c, a))

    def add_int(self, a, c: int):
        return gl.add(a, self._const(c, a))


class HostExtAlgebra:
    """Constraints over exact ext-int tuples (OOD point evaluation)."""

    def add(self, a, b):
        return fi.eadd(a, b)

    def sub(self, a, b):
        return fi.esub(a, b)

    def mul(self, a, b):
        return fi.emul(a, b)

    def mul_int(self, a, c: int):
        return fi.escale(a, c % P)

    def add_int(self, a, c: int):
        return fi.eadd(a, (c % P, 0))


@dataclasses.dataclass(frozen=True)
class Air:
    """An algebraic intermediate representation.

    eval_transitions(alg, row, next_row) -> list of constraint values; `row`
    is a list of `width` column values (field tensors on the device, ext
    tuples on the host). Transition constraints must hold on rows 0..N-2.
    boundary: list of (row_index, col_index, value) assertions.
    """

    width: int
    log_n: int
    constraint_degree: int
    num_transitions: int
    eval_transitions: Callable
    boundary: Tuple[Tuple[int, int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class StarkConfig:
    lde_factor: int = 4
    cap_size: int = 16
    num_queries: int = 40
    final_fri_size: int = 32  # final FRI codeword size

    def fri_config(self, n_lde: int) -> FriConfig:
        rounds = (n_lde // self.final_fri_size).bit_length() - 1
        return FriConfig(folding_rounds=rounds, cap_size=self.cap_size,
                         num_queries=self.num_queries,
                         lde_factor=self.lde_factor)


@dataclasses.dataclass
class StarkProof:
    trace_cap: np.ndarray
    quotient_cap: np.ndarray
    ood_trace: List[Tuple[int, int]]  # T_j(z)
    ood_trace_next: List[Tuple[int, int]]  # T_j(z w)
    ood_quotient: List[Tuple[int, int]]  # Q_j(z)
    trace_openings: Dict[int, List[int]]  # lde index -> row values
    trace_paths: Dict[int, np.ndarray]
    quotient_openings: Dict[int, List[int]]
    quotient_paths: Dict[int, np.ndarray]
    fri: FriProof


def _lde_points(n_lde: int, shift: int, device) -> GF:
    """x_i = shift * v^i on the LDE coset, v of order n_lde (cached)."""
    v = gl.primitive_root_of_unity(n_lde.bit_length() - 1)
    return gl.powers_dev_cached(v, n_lde, mult=shift, device=device)


def _zh_over_last_inv(n: int, lde: int, shift: int,
                      device=None) -> Tuple[GF, GF]:
    """1/Z_Ht(x_i) on the LDE coset, where Z_Ht(x) = (x^N - 1)/(x -
    w^{N-1}); also returns the (x_i - w^{N-1}) vector.

    x_i^N is periodic with period `lde`, so only `lde` exact inversions
    happen on the host; the (x - w_last) vector is built on the device from
    the coset's power table (the JAX package builds it from host ints: the
    values are field elements, so both give the same bits) and folded into
    the quotient there."""
    device = gl.resolve_device(device)
    n_lde = n * lde
    w_last = pow(gl.primitive_root_of_unity(n.bit_length() - 1), n - 1, P)
    t = pow(gl.primitive_root_of_unity(n_lde.bit_length() - 1), n, P)
    g_n = pow(shift, n, P)
    zh_inv_small = [pow((g_n * pow(t, i, P) - 1) % P, P - 2, P)
                    for i in range(lde)]
    zh_inv = gl.from_int(zh_inv_small, device).repeat(n)
    xs = _lde_points(n_lde, shift, device)
    return zh_inv, gl.sub(xs, gl.scalar_like(w_last, xs))


def _ext_scaled(a: Tuple[int, int], v: GF) -> GF2:
    """The ext scalar `a` times the base vector `v`."""
    return GF2(gl.mul(v, gl.scalar_like(a[0], v)),
               gl.mul(v, gl.scalar_like(a[1], v)))


def prove(air: Air, trace: GF, cfg: StarkConfig = StarkConfig(),
          device=None) -> StarkProof:
    """trace: (width, N) base-field execution trace (natural row order),
    already on `device`."""
    device = gl.resolve_device(device)
    if trace.device != device:
        raise ValueError(f"trace is on {trace.device}, prove runs on {device}")
    n = 1 << air.log_n
    lde = cfg.lde_factor
    n_lde = n * lde
    shift = gl.MULTIPLICATIVE_GENERATOR
    assert tuple(trace.shape) == (air.width, n)
    tr = Transcript(device=device)

    # -- 1. trace commitment ----------------------------------------------
    with tracing.span("stark.trace_commit"):
        trace_coeffs = nt.intt(trace)  # (W, N)
        trace_lde = nt.lde_from_coeffs(trace_coeffs, n_lde, shift)
        leaf_rows = trace_lde.t().contiguous()  # (N_lde, W)
        trace_tree = mk.build_tree(mk.hash_leaves(leaf_rows), cfg.cap_size)
        trace_cap = gl.to_ints(trace_tree.cap)
        tr.absorb_ints([int(x) for x in trace_cap.ravel()])

    # -- 2. constraint composition on the LDE domain ----------------------
    with tracing.span("stark.composition"):
        alpha = tr.challenge_ext_ints()
        cols = [trace_lde[i] for i in range(air.width)]
        next_cols = [torch.roll(c, -lde) for c in cols]
        cvals = air.eval_transitions(DeviceAlgebra(), cols, next_cols)
        assert len(cvals) == air.num_transitions
        with tracing.span("stark.zh_over_last_inv"):
            zh_inv, x_minus_last = _zh_over_last_inv(n, lde, shift, device)

        # combine transitions with alpha powers (ext scalars x base vectors)
        apow = (1, 0)
        comb = gl.ext_zeros((n_lde,), device)
        for cv in cvals:
            apow = fi.emul(apow, alpha)
            comb = gl.ext_add(comb, _ext_scaled(apow, cv))
        # transition quotient: comb * (x - w_last) / (x^N - 1)
        comb = gl.ext_mul_base(gl.ext_mul_base(comb, x_minus_last), zh_inv)

        # boundary terms: alpha^{T+j+1} * (T_col(x) - val) / (x - pt)
        if air.boundary:
            w = gl.primitive_root_of_unity(air.log_n)
            xs = _lde_points(n_lde, shift, device)
            for (row_idx, col_idx, value) in air.boundary:
                apow = fi.emul(apow, alpha)
                pt = pow(w, row_idx, P)
                denom_inv = gl.inv(gl.sub(xs, gl.scalar_like(pt, xs)))
                num = gl.sub(cols[col_idx], gl.scalar_like(value, xs))
                comb = gl.ext_add(comb, _ext_scaled(apow, gl.mul(num,
                                                                 denom_inv)))

    # -- 3. quotient split + commitment -----------------------------------
    with tracing.span("stark.quotient_commit"):
        num_chunks = max(1, air.constraint_degree)
        assert num_chunks <= lde, "lde_factor must cover the composition degree"
        # coefficients of the composition (coset intt + unscale)
        unscale = gl.powers_dev_cached(pow(shift, P - 2, P), n_lde,
                                       device=device)
        comp_c0 = gl.mul(nt.intt(comb.c0), unscale)
        comp_c1 = gl.mul(nt.intt(comb.c1), unscale)
        del comb
        # chunks j: coeffs [jN, (j+1)N); re-evaluate each on the LDE coset
        q_coeffs = gl.stack([comp[j * n:(j + 1) * n]
                             for j in range(num_chunks)
                             for comp in (comp_c0, comp_c1)], axis=0)
        q_lde = nt.lde_from_coeffs(q_coeffs, n_lde, shift)
        q_leaf_rows = q_lde.t().contiguous()
        q_tree = mk.build_tree(mk.hash_leaves(q_leaf_rows), cfg.cap_size)
        q_cap = gl.to_ints(q_tree.cap)
        tr.absorb_ints([int(x) for x in q_cap.ravel()])

    # -- 4. OOD evaluations ------------------------------------------------
    with tracing.span("stark.ood"):
        z = tr.challenge_ext_ints()
        zw = fi.escale(z, gl.primitive_root_of_unity(air.log_n))
        ood_trace = _ext_evals(trace_coeffs, z, device)
        ood_trace_next = _ext_evals(trace_coeffs, zw, device)
        ood_quotient = _ext_evals(q_coeffs, z, device)  # per (chunk, comp)
        for pair in ood_trace + ood_trace_next + ood_quotient:
            tr.absorb_ints(list(pair))

    # -- 5. DEEP composition ----------------------------------------------
    with tracing.span("stark.deep"):
        gamma = tr.challenge_ext_ints()
        deep = _deep_composition(trace_lde, q_lde, ood_trace, ood_trace_next,
                                 ood_quotient, z, zw, gamma,
                                 _lde_points(n_lde, shift, device))

    # -- 6. FRI -------------------------------------------------------------
    with tracing.span("stark.fri"):
        fri_proof = fri_prove(deep, shift, tr, cfg.fri_config(n_lde))
        del deep

    # -- 7. query openings --------------------------------------------------
    with tracing.span("stark.openings"):
        h0 = n_lde // 2
        idx_set = sorted({int(p) % h0 for p in fri_proof.query_positions} |
                         {int(p) % h0 + h0 for p in fri_proof.query_positions})
        idx_arr = np.array(idx_set, dtype=np.uint32)
        t_open = gl.to_ints(gl.take(leaf_rows, idx_arr, axis=0))
        t_paths = gl.to_ints(mk.open_indices(trace_tree, idx_arr))
        q_open = gl.to_ints(gl.take(q_leaf_rows, idx_arr, axis=0))
        q_paths = gl.to_ints(mk.open_indices(q_tree, idx_arr))

    return StarkProof(
        trace_cap=trace_cap,
        quotient_cap=q_cap,
        ood_trace=ood_trace,
        ood_trace_next=ood_trace_next,
        ood_quotient=ood_quotient,
        trace_openings={int(i): [int(v) for v in t_open[k]]
                        for k, i in enumerate(idx_set)},
        trace_paths={int(i): t_paths[k] for k, i in enumerate(idx_set)},
        quotient_openings={int(i): [int(v) for v in q_open[k]]
                           for k, i in enumerate(idx_set)},
        quotient_paths={int(i): q_paths[k] for k, i in enumerate(idx_set)},
        fri=fri_proof,
    )


def _ext_evals(coeffs: GF, x: Tuple[int, int],
               device) -> List[Tuple[int, int]]:
    evals = nt.eval_poly_at(coeffs, gl.ext_from_ints(x[0], x[1], device))
    c0 = gl.to_ints(evals.c0)
    c1 = gl.to_ints(evals.c1)
    return [(int(a), int(b)) for a, b in zip(np.atleast_1d(c0),
                                             np.atleast_1d(c1))]


def _deep_composition(trace_lde: GF, q_lde: GF, ood_trace, ood_trace_next,
                      ood_quotient, z, zw, gamma, xs: GF) -> GF2:
    """D(x) = sum_j g^j (T_j(x)-T_j(z))/(x-z) + ... over trace, next,
    quotient."""

    def inv_x_minus(pt):
        return gl.ext_inv(GF2(gl.sub(xs, gl.scalar_like(pt[0], xs)),
                              gl.neg(gl.scalar_like(pt[1], xs)).expand(
                                  xs.shape)))

    inv_xz = inv_x_minus(z)
    inv_xzw = inv_x_minus(zw)
    deep = gl.ext_zeros(xs.shape, xs.device)
    gpow = (1, 0)
    terms = ([(trace_lde[j], ood_trace[j], inv_xz)
              for j in range(trace_lde.shape[0])]
             + [(trace_lde[j], ood_trace_next[j], inv_xzw)
                for j in range(trace_lde.shape[0])]
             + [(q_lde[j], ood_quotient[j], inv_xz)
                for j in range(q_lde.shape[0])])
    for col, ood, inv_den in terms:
        gpow = fi.emul(gpow, gamma)
        num = GF2(gl.sub(col, gl.scalar_like(ood[0], col)),
                  gl.neg(gl.scalar_like(ood[1], col)))
        g = gl.ext_from_ints(gpow[0], gpow[1], col.device)
        deep = gl.ext_add(deep, gl.ext_mul(g, gl.ext_mul(num, inv_den)))
    return deep


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def _verify_inner(air: Air, proof: StarkProof,
                  cfg: StarkConfig = StarkConfig(), device=None) -> bool:
    device = gl.resolve_device(device)
    n = 1 << air.log_n
    lde = cfg.lde_factor
    n_lde = n * lde
    shift = gl.MULTIPLICATIVE_GENERATOR
    num_chunks = max(1, air.constraint_degree)
    tr = Transcript(device=device)

    # Geometry binding: every absorbed OOD value must later receive a DEEP
    # term, and every opened row must have exactly the committed width —
    # otherwise a prover can commit a narrower quotient and solve the
    # unbound tail chunk to satisfy the OOD identity for any trace.
    if (len(proof.ood_trace) != air.width
            or len(proof.ood_trace_next) != air.width
            or len(proof.ood_quotient) != 2 * num_chunks):
        return False
    for i in proof.trace_openings:
        if (len(proof.trace_openings[i]) != air.width
                or len(proof.quotient_openings.get(i, ())) != 2 * num_chunks):
            return False
    if set(proof.trace_openings.keys()) != set(proof.quotient_openings.keys()):
        return False

    tr.absorb_ints([int(x) for x in
                    np.asarray(proof.trace_cap, dtype=object).ravel()])
    alpha = tr.challenge_ext_ints()
    tr.absorb_ints([int(x) for x in
                    np.asarray(proof.quotient_cap, dtype=object).ravel()])
    z = tr.challenge_ext_ints()
    w_gen = gl.primitive_root_of_unity(air.log_n)
    zw = fi.escale(z, w_gen)
    for pair in proof.ood_trace + proof.ood_trace_next + proof.ood_quotient:
        tr.absorb_ints(list(pair))
    gamma = tr.challenge_ext_ints()

    # -- OOD consistency: constraints at z vs quotient chunks at z ---------
    cvals = air.eval_transitions(HostExtAlgebra(), proof.ood_trace,
                                 proof.ood_trace_next)
    apow = (1, 0)
    comb = (0, 0)
    for cv in cvals:
        apow = fi.emul(apow, alpha)
        comb = fi.eadd(comb, fi.emul(apow, cv))
    zn = fi.epow(z, n)
    w_last = pow(w_gen, n - 1, P)
    zh = fi.esub(zn, (1, 0))
    z_min_last = fi.esub(z, (w_last, 0))
    comb = fi.emul(comb, fi.emul(z_min_last, fi.einv(zh)))
    for (row_idx, col_idx, value) in air.boundary:
        apow = fi.emul(apow, alpha)
        pt = pow(w_gen, row_idx, P)
        num = fi.esub(proof.ood_trace[col_idx], (value % P, 0))
        comb = fi.eadd(comb, fi.emul(apow, fi.emul(
            num, fi.einv(fi.esub(z, (pt, 0))))))
    # The quotient chunks are the c0/c1 component polynomials of the ext
    # composition: Comp(z) = sum_j z^{jN} (Q0_j(z) + x_ext * Q1_j(z)) where
    # x_ext is the ext generator (0,1).
    expected = (0, 0)
    zjn = (1, 0)
    for j in range(num_chunks):
        q0 = proof.ood_quotient[2 * j]
        q1 = proof.ood_quotient[2 * j + 1]
        qz = fi.eadd(q0, fi.emul((0, 1), q1))
        expected = fi.eadd(expected, fi.emul(zjn, qz))
        zjn = fi.emul(zjn, zn)
    if comb != expected:
        return False

    # -- Merkle openings ----------------------------------------------------
    fri_cfg = cfg.fri_config(n_lde)
    idx_list = sorted(proof.trace_openings.keys())
    idx_arr = np.array(idx_list, dtype=np.uint32)
    for openings, paths, cap_np in (
            (proof.trace_openings, proof.trace_paths, proof.trace_cap),
            (proof.quotient_openings, proof.quotient_paths,
             proof.quotient_cap)):
        rows = gl.from_int(np.array([openings[i] for i in idx_list],
                                    dtype=object), device)
        paths_gf = gl.from_int(np.stack([np.asarray(paths[i], dtype=object)
                                         for i in idx_list]), device)
        cap_gf = gl.from_int(np.asarray(cap_np, dtype=object), device)
        ok = mk.verify_paths(mk.hash_leaves(rows), idx_arr, paths_gf, cap_gf,
                             n_leaves=n_lde, cap_size=cfg.cap_size)
        if not bool(ok.all()):
            return False

    # -- DEEP values at queried indices (host ints) -----------------------
    v = gl.primitive_root_of_unity(n_lde.bit_length() - 1)

    def deep_at(idx: int) -> Tuple[int, int]:
        x = (shift * pow(v, idx, P)) % P
        t_row = proof.trace_openings[idx]
        q_row = proof.quotient_openings[idx]
        acc = (0, 0)
        gpow = (1, 0)
        inv_xz = fi.einv(fi.esub((x, 0), z))
        inv_xzw = fi.einv(fi.esub((x, 0), zw))
        for j in range(air.width):
            gpow = fi.emul(gpow, gamma)
            num = fi.esub((t_row[j], 0), proof.ood_trace[j])
            acc = fi.eadd(acc, fi.emul(gpow, fi.emul(num, inv_xz)))
        for j in range(air.width):
            gpow = fi.emul(gpow, gamma)
            num = fi.esub((t_row[j], 0), proof.ood_trace_next[j])
            acc = fi.eadd(acc, fi.emul(gpow, fi.emul(num, inv_xzw)))
        for j in range(2 * num_chunks):
            gpow = fi.emul(gpow, gamma)
            num = fi.esub((q_row[j], 0), proof.ood_quotient[j])
            acc = fi.eadd(acc, fi.emul(gpow, fi.emul(num, inv_xz)))
        return acc

    return fri_verify(proof.fri, n_lde, shift, tr, fri_cfg, deep_at)


def verify(air: Air, proof: StarkProof, cfg: StarkConfig = StarkConfig(),
           device=None, strict: bool = None) -> bool:
    """Structural-error-tolerant wrapper: a malformed proof (wrong lengths,
    bad types, truncated openings) must REJECT, not crash the verifier.
    `strict=True` (or env ZKEVM_VERIFY_STRICT=1) re-raises instead, so
    internal invariant bugs cannot hide behind "proof rejected".

    `device=None` means the CUDA card and raises where there is none, before
    any proof data is read."""
    from .guard import tolerant_verify
    device = gl.resolve_device(device)
    return tolerant_verify(_verify_inner, air, proof, cfg, device,
                           strict=strict)
