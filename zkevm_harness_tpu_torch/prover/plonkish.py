"""PLONKish constraint system prover/verifier (gates + copy permutation +
logup lookups) on FRI, in PyTorch.

Counterpart of the JAX package's `prover/plonkish.py`, Goldilocks-Poseidon2
path with the degree-stratified quotient. Transcript order, proof layout and
JSON serialisation are the reference's: a proof of the same circuit, witness
and config is equal to the JAX package's value for value.

Design:
  - TWO domains: the commitment domain (N * rate) for Merkle/FRI, and a
    larger evaluation domain (N * lde_eval, lde_eval >= max constraint
    degree) for the quotient, evaluated COSET BY COSET.
  - Each constraint family is evaluated only on the cosets its degree needs
    (`PlonkishIR.gate_part_degrees`); the per-class coefficient vectors sum
    to the same quotient polynomial.
  - copy-permutation z / partial-product columns and the logup helper columns
    live in GF(p^2); their prefix product / prefix sum over rows are
    log-depth doubling loops on the field kernels.
  - A circuit that declares no `gate_part_degrees` takes the unstratified
    composition: every family on every coset, one class of the full size.
  - Memory schedule: streamed by default. Every committed bundle keeps its
    coefficients; its commitment-domain LDE is recomputed when the DEEP
    combination and the query openings need it, so one bundle's LDE is alive
    at a time. With `RETAIN_LDE` set, each LDE is kept from its commit on
    and computed once. Both schedules give the same proof.

Every device step is plain tensor code on top of the field kernels
(`ops/cuda_kernels.py`); the Merkle trees and the transcript go through the
Poseidon2 kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import poseidon2 as p2
from ..ops.goldilocks import GF, GF2, P
from ..parallel import mesh as pm
from ..utils import field_int as fi
from ..utils import tracing
from .fri import FriConfig, fri_prove, fri_verify
from .stark import DeviceAlgebra, HostExtAlgebra
from .transcript import Transcript

K_COSET_GEN = gl.MULTIPLICATIVE_GENERATOR  # column coset reps k_j = 7^j

# The prover's blocked passes: the quotient's weighted sum of gate
# constraints, its gate parts, copy terms and public-input terms, stage 2's
# copy columns, the DEEP dot products, and the LDE of a commitment, of DEEP
# and of the openings made without a kept one. On rows of up to
# `_BLOCKED_ROWS` values each pass takes its natural block: `_WSUM_CHUNK`
# values, `_COPY_BLOCK_COLS` columns, a whole gate part or bundle. On longer
# rows a block holds no more than `_BLOCK_BYTES`, so the working set of a
# 2^22- or 2^23-row leaf stays that of a 2^20-row circuit, and a gate part
# is split into blocks of rows, none shorter than `_BLOCKED_ROWS` (a part
# makes a few launches per constraint for every block: the log demuxer's
# 9,894 x 2^16 prove took 94.0 s in blocks of 4,096 rows against 20.2 s
# whole, the same proof; NVIDIA H100 80GB HBM3, 700 W, one run). Field
# addition is exact, so any blocking gives the same sums and proof.
_WSUM_CHUNK = 256
_COPY_BLOCK_COLS = 1024
_BLOCKED_ROWS = 1 << 20
_BLOCK_BYTES = 1 << 29


def _block_rows(row_len: int, natural: int, domain: int = None) -> int:
    """Rows of `row_len` values that a blocked pass takes at a time: its
    `natural` count where the rows' domain (`domain`, else `row_len`) has
    no more than `_BLOCKED_ROWS` points, else no more than `_BLOCK_BYTES`
    hold."""
    if (row_len if domain is None else domain) <= _BLOCKED_ROWS:
        return natural
    return max(1, min(natural, _BLOCK_BYTES // (8 * int(row_len))))


# Memory schedule of `prove` (the JAX package picks it by backend and has the
# test hook FORCE_LEAN; the port has one device, so one switch): False
# streams, recomputing a bundle's commitment LDE from its coefficients where
# DEEP and the openings need it; True keeps every LDE from its commit on.
RETAIN_LDE = False

# The last prove on a CUDA device: the device's running peak of allocated
# bytes (`torch.cuda.max_memory_allocated`) at the end of each prover
# stage, so the stage that set a task's peak reads off its first reaching
# the final value.
STAGE_PEAKS: Dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class PlonkishIR:
    """Static circuit description (geometry + gate evaluator).

    eval_gates(alg, w, w_next, c) -> list of constraint values, where `w` is
    the list of witness columns, `w_next` the cyclic next-row witness, and `c`
    the constant/setup columns (selectors etc.).
    """

    log_n: int
    num_witness: int
    num_const: int
    gate_degree: int
    num_gate_constraints: int
    eval_gates: Callable
    copy_chunk: int = 3  # witness columns per partial-product chunk
    public_input_cells: Tuple[Tuple[int, int], ...] = ()  # (col, row)
    # lookup argument (logup with inverse-helper columns, all degree <= 2):
    # lookup_tables[t] = np.ndarray (entries, L_t); lookup_sets[s] =
    # (table_idx, (witness col indices of width L_t)). Every row of the listed
    # witness columns must be a row of the table.
    lookup_tables: Tuple = ()
    lookup_sets: Tuple = ()
    # optional CHUNKED gate evaluation: a tuple of functions with the
    # eval_gates signature whose concatenated outputs equal eval_gates exactly
    # (same order), plus per-part constraint counts.
    eval_gates_parts: "Optional[Tuple[Callable, ...]]" = None
    gate_part_counts: "Optional[Tuple[int, ...]]" = None
    # DEGREE STRATIFICATION of the quotient (prover-only; the quotient
    # polynomial, and therefore the proof, does not depend on it, since a
    # constraint family whose quotient has degree < D*n is exactly determined
    # by its values on D cosets). Per gate part: its max algebraic degree in
    # the (witness, const) polynomials (e.g. sel*w*w -> 3) and optionally the
    # witness columns it reads. `stratify` derives both for a circuit that
    # does not declare them; without them every family runs on every coset.
    gate_part_degrees: "Optional[Tuple[int, ...]]" = None
    gate_part_cols: "Optional[Tuple[Optional[Tuple[int, ...]], ...]]" = None


@dataclasses.dataclass
class PlonkishSetup:
    """Preprocessed circuit data (the VK-side artifacts): constant columns,
    copy-permutation sigma columns (as field elements k_{j'} w^{i'}), padded
    lookup tables, and their Merkle commitment."""

    const_cols: GF  # (num_const, n)
    sigma_cols: GF  # (num_witness, n)
    table_cols: GF  # (sum of table widths, n) padded lookup tables
    table_np: Tuple  # per-table padded (n, L) int arrays (multiplicity calc)
    tree: mk.MerkleTree
    cap_np: np.ndarray

    def vk(self) -> List[int]:
        return [int(v) for v in self.cap_np.ravel()]


@dataclasses.dataclass(frozen=True)
class PlonkishConfig:
    rate: int = 2  # commitment-domain LDE factor
    cap_size: int = 16
    num_queries: int = 40
    final_fri_size: int = 32

    def fri_config(self, n_comm: int) -> FriConfig:
        rounds = (n_comm // self.final_fri_size).bit_length() - 1
        return FriConfig(folding_rounds=rounds, cap_size=self.cap_size,
                         num_queries=self.num_queries, lde_factor=self.rate)


@dataclasses.dataclass
class PlonkishProof:
    public_inputs: List[int]
    witness_cap: np.ndarray
    stage2_cap: np.ndarray
    quotient_cap: np.ndarray
    ood_witness: List[Tuple[int, int]]
    ood_witness_next: List[Tuple[int, int]]
    ood_stage2: List[Tuple[int, int]]
    ood_stage2_next: List[Tuple[int, int]]
    stage3_cap: np.ndarray
    ood_stage3: List[Tuple[int, int]]
    ood_stage3_next: List[Tuple[int, int]]
    ood_table: List[Tuple[int, int]]
    ood_const: List[Tuple[int, int]]
    ood_sigma: List[Tuple[int, int]]
    ood_quotient: List[Tuple[int, int]]
    openings: Dict[str, Dict[int, List[int]]]  # tree -> idx -> row values
    paths: Dict[str, Dict[int, np.ndarray]]
    fri: "object"


# ---------------------------------------------------------------------------
# Setup construction
# ---------------------------------------------------------------------------

def _commit_cols_from_coeffs(coeffs: GF, n_comm: int, cap_size: int,
                             keep_lde: bool = True):
    """(LDE, Merkle tree) of coefficient rows on the commitment domain (leaf
    l hashes column values at LDE index l). The retained schedule keeps the
    LDE. Without `keep_lde` (the streamed schedule, a setup) None stands
    for it, and on rows longer than `_BLOCKED_ROWS` it is made and hashed a
    block of columns at a time, `_block_rows` rounded to whole rate-8
    chunks, which the leaf sponge absorbs in column order."""
    if keep_lde or n_comm <= _BLOCKED_ROWS:
        lde = nt.lde_from_coeffs(coeffs, n_comm)
        tree = mk.commit(lde.t(), cap_size)
        return (lde if keep_lde else None), tree
    step = p2.RATE * max(1, _block_rows(n_comm, coeffs.shape[0]) // p2.RATE)
    state = None
    for j in range(0, max(1, coeffs.shape[0]), step):
        lde = nt.lde_from_coeffs(coeffs[j:j + step], n_comm)
        state = p2.absorb_elements(state, lde.t())
        del lde
    return None, mk.build_tree(state[..., :mk.DIGEST_WIDTH], cap_size)


def _commit_cols_with_coeffs(cols: GF, rate: int, cap_size: int,
                             keep_lde: bool = True):
    """(coefficients, LDE, tree): the INTT runs once and feeds both."""
    coeffs = nt.intt(cols)
    lde, tree = _commit_cols_from_coeffs(coeffs, cols.shape[-1] * rate,
                                         cap_size, keep_lde)
    return coeffs, lde, tree


def build_setup(ir: PlonkishIR, const_cols_int: np.ndarray,
                wiring: "CopyWiring",
                cfg: PlonkishConfig = PlonkishConfig(),
                device=None) -> PlonkishSetup:
    """const_cols_int: (num_const, n) ints (Python or numpy); wiring: the
    copy permutation as the cells it moves (`CopyWiring.identity()` where
    nothing is copied)."""
    device = gl.resolve_device(device)
    n = 1 << ir.log_n
    w = gl.primitive_root_of_unity(ir.log_n)
    # sigma[j, i] = k_j * w^i everywhere, then the wired cells' successors
    w_pows = gl.powers_dev_cached(w, n, device=device)
    ks_vec = gl.powers_dev_cached(K_COSET_GEN, max(ir.num_witness, 1),
                                  device=device)
    sigma_cols = gl.mul(ks_vec[:ir.num_witness, None], w_pows[None, :])
    cells = torch.from_numpy(wiring.cells).to(device)
    succ = torch.from_numpy(wiring.succ).to(device)
    sigma_cols.view(-1)[cells] = gl.mul(ks_vec[succ // n], w_pows[succ % n])
    del cells, succ
    const_cols = (gl.from_int(const_cols_int, device) if ir.num_const
                  else gl.zeros((0, n), device))
    # pad lookup tables to n rows (repeat entry 0) and lay out as columns
    table_np = []
    tcol_list = []
    for tbl in ir.lookup_tables:
        tbl = np.asarray(tbl, dtype=object)
        assert tbl.shape[0] <= n, "table larger than trace domain"
        pad_rows = n - tbl.shape[0]
        padded = (np.vstack([tbl, np.repeat(tbl[:1], pad_rows, axis=0)])
                  if pad_rows else tbl)
        table_np.append(padded)
        for j in range(padded.shape[1]):
            tcol_list.append(padded[:, j])
    table_cols = (gl.from_int(np.stack(tcol_list), device) if tcol_list
                  else gl.zeros((0, n), device))
    return setup_from_columns(const_cols, sigma_cols, table_cols,
                              tuple(table_np), cfg)


def setup_from_columns(const_cols: GF, sigma_cols: GF, table_cols: GF,
                       table_np: Tuple, cfg: PlonkishConfig) -> PlonkishSetup:
    """Commit [const || sigma || tables] on the commitment domain."""
    all_cols = gl.concatenate([const_cols, sigma_cols, table_cols], axis=0)
    _coeffs, _lde, tree = _commit_cols_with_coeffs(all_cols, cfg.rate,
                                                   cfg.cap_size,
                                                   keep_lde=False)
    del _coeffs, all_cols
    return PlonkishSetup(const_cols=const_cols, sigma_cols=sigma_cols,
                         table_cols=table_cols, table_np=table_np,
                         tree=tree, cap_np=gl.to_ints(tree.cap))


@dataclasses.dataclass
class CopyWiring:
    """A copy permutation given by the cells it moves: cell `cells[i]`
    (flat index col * n + row) has successor `succ[i]`; every other cell is
    its own successor. A dense (num_witness, n, 2) successor array would take
    gigabytes for the wide circuits."""

    cells: np.ndarray  # int64
    succ: np.ndarray   # int64

    @staticmethod
    def identity() -> "CopyWiring":
        """No cell is copied to another."""
        return CopyWiring(np.zeros(0, np.int64), np.zeros(0, np.int64))


def wire_copy_pairs(n: int, a: np.ndarray, b: np.ndarray) -> CopyWiring:
    """The JAX package's `apply_copy_cycles` on the identity, for linked
    pairs (a[i], b[i]) taken in order ((m, 2) arrays of (col, row); cycle
    [c0, c1, c2] is the pairs (c0, c1), (c1, c2)); the same successors, as a
    `CopyWiring`.

    The wide circuits wire millions of pairs, each joining a cell that no
    other pair names (a sponge-tile cell) to a cell that several may share
    (a staged encoding cell that seven queue regions read). Such a pair
    joins two different orbits, so its merge is the swap of the two cells'
    successors, and swaps commute unless they touch one cell. Applying the
    k-th pair of every shared cell together, for k = 0, 1, ..., is then the
    sequential merge exactly, vectorised. A pair whose two cells are both
    named by other pairs is refused: its merge may join one orbit to itself,
    which this vectorised form does not cover."""
    fa = a[:, 0] * n + a[:, 1]
    fb = b[:, 0] * n + b[:, 1]
    if len(fa) == 0:
        return CopyWiring.identity()
    ids, inv, counts = np.unique(np.concatenate([fa, fb]),
                                 return_inverse=True, return_counts=True)
    ca, cb = counts[inv[:len(fa)]], counts[inv[len(fa):]]
    if np.any((ca > 1) & (cb > 1)):
        raise ValueError("wire_copy_pairs: a pair whose cells are both "
                         "shared with other pairs")
    a_shared = ca > 1
    shared = np.where(a_shared, fa, fb)
    fresh = np.where(a_shared, fb, fa)
    # rank of each pair among the pairs of its shared cell, in pair order
    order = np.argsort(shared, kind="stable")
    srt = shared[order]
    starts = np.r_[0, np.flatnonzero(srt[1:] != srt[:-1]) + 1]
    rank = np.empty(len(srt), dtype=np.int64)
    rank[order] = np.arange(len(srt)) - np.repeat(
        starts, np.diff(np.r_[starts, len(srt)]))
    # successor table over the touched cells only, identity to begin with
    succ = ids.copy()
    pos_shared = np.searchsorted(ids, shared)
    pos_fresh = np.searchsorted(ids, fresh)
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        ps, pf = pos_shared[sel], pos_fresh[sel]
        succ[ps], succ[pf] = succ[pf], succ[ps].copy()
    moved = succ != ids
    return CopyWiring(ids[moved], succ[moved])


def wire_copy_cycles(n: int, cycles) -> CopyWiring:
    """The JAX package's `apply_copy_cycles` on the identity for short
    cycles of (col, row) cells, each cycle [c0, c1, c2, ...] taken as its
    linked pairs (c0, c1), (c1, c2), ... (`wire_copy_pairs`)."""
    pairs = [(c[i], c[i + 1]) for c in cycles for i in range(len(c) - 1)]
    a = np.array([p[0] for p in pairs], dtype=np.int64).reshape(-1, 2)
    b = np.array([p[1] for p in pairs], dtype=np.int64).reshape(-1, 2)
    return wire_copy_pairs(n, a, b)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _copy_chunks(num_witness: int, chunk: int) -> List[List[int]]:
    return [list(range(s, min(s + chunk, num_witness)))
            for s in range(0, num_witness, chunk)]


def _lin_term_device(w_col: GF, id_or_sigma: GF, beta: GF2,
                     gamma: GF2) -> GF2:
    """(w + beta * m + gamma) as an ext tensor; w, m base tensors."""
    return GF2(gl.add(gl.add(w_col, gl.mul(id_or_sigma, beta.c0)), gamma.c0),
               gl.add(gl.mul(id_or_sigma, beta.c1), gamma.c1))


def _ext_scan_inclusive(x: GF2, op) -> GF2:
    """Inclusive scan of `op` (associative, commutative, exact) over the last
    axis by doubling: after the step of distance d, entry i holds the
    combination of entries (i - 2d, i]."""
    n = x.shape[-1]
    d = 1
    while d < n:
        tail = op(x[..., d:], x[..., :n - d])
        x = GF2(torch.cat([x.c0[..., :d], tail.c0], dim=-1),
                torch.cat([x.c1[..., :d], tail.c1], dim=-1))
        d *= 2
    return x


def _ext_prefix_product_exclusive(ratios: GF2) -> GF2:
    """z[0]=1, z[i] = prod_{t<i} ratios[t] (log-depth doubling scan)."""
    inc = _ext_scan_inclusive(ratios, gl.ext_mul)
    return GF2(torch.cat([torch.ones_like(inc.c0[:1]), inc.c0[:-1]]),
               torch.cat([torch.zeros_like(inc.c1[:1]), inc.c1[:-1]]))


def _ext_prefix_sum_exclusive(deltas: GF2) -> GF2:
    """S[0]=0, S[i] = sum_{t<i} deltas[t] (log-depth doubling scan)."""
    inc = _ext_scan_inclusive(deltas, gl.ext_add)
    return GF2(torch.cat([torch.zeros_like(inc.c0[:1]), inc.c0[:-1]]),
               torch.cat([torch.zeros_like(inc.c1[:1]), inc.c1[:-1]]))


def _rank_in(sorted_vals: np.ndarray, x: np.ndarray):
    """(index of each x in `sorted_vals`, whether it is really there)."""
    idx = np.minimum(np.searchsorted(sorted_vals, x), len(sorted_vals) - 1)
    return idx, sorted_vals[idx] == x


def _multiplicities(ir, setup, wit_np, n):
    """Per-table multiplicity columns (host; witness-gen side), as uint64.

    m[r] counts the witness tuples, over every lookup set of the table, that
    equal table row r, booked on the FIRST row holding that tuple (the
    padding repeats entry 0). Only the table is sorted: column by column,
    each witness value is ranked among the table's values by binary search
    and folded into a tuple id, which is ranked again among the table's ids,
    so an id stays below n whatever the field values are (uint64 throughout:
    values above 2^63 order and compare as unsigned).
    `tests/test_torch_plonkish_paths.py` holds it against the row-by-row
    walk."""
    ms = []
    for t_idx, padded in enumerate(setup.table_np):
        sets = [cols for (tbl, cols) in ir.lookup_sets if tbl == t_idx]
        m = np.zeros(n, dtype=np.uint64)
        if sets:
            table = np.asarray(padded).astype(np.uint64)
            n_tbl = table.shape[0]
            keys = np.concatenate(
                [np.stack([np.asarray(wit_np[c], dtype=np.uint64)
                           for c in cols], axis=1) for cols in sets])
            weights = None
            if table.shape[1] == 1:
                # range checks, the bulk of the look-ups: sorting the keys
                # is far cheaper than a binary search for each of them
                distinct, weights = np.unique(keys[:, 0], return_counts=True)
                keys = distinct[:, None]
            vals = np.unique(table[:, 0])
            t_id = np.searchsorted(vals, table[:, 0])
            k_id, hit = _rank_in(vals, keys[:, 0])
            n_ids = len(vals)
            for j in range(1, table.shape[1]):
                vals = np.unique(table[:, j])
                k_rank, there = _rank_in(vals, keys[:, j])
                t_packed = t_id * len(vals) + np.searchsorted(vals,
                                                              table[:, j])
                ids = np.unique(t_packed)
                t_id = np.searchsorted(ids, t_packed)
                k_id, known = _rank_in(ids, k_id * len(vals) + k_rank)
                hit &= there & known
                n_ids = len(ids)
            if not hit.all():
                k = int(np.flatnonzero(~hit)[0])
                where = (f"value {int(keys[k, 0])}" if weights is not None
                         else f"set {sets[k // n]} row {k % n}")
                raise AssertionError(f"lookup miss: table {t_idx} {where}")
            first = np.empty(n_ids, dtype=np.int64)
            # reversed, so that the lowest row of equal tuples is kept
            first[t_id[::-1]] = np.arange(n_tbl - 1, -1, -1)
            # (with weights bincount sums in float64: exact below 2^53)
            counts = np.bincount(k_id, weights=weights, minlength=n_ids)
            used = counts > 0
            m[first[used]] = counts[used].astype(np.uint64)
        ms.append(m)
    return ms


def _compress_theta(cols: List[GF], theta: GF2) -> GF2:
    """sum_j theta^j * cols[j] as an ext tensor; theta a GF2 scalar."""
    acc = GF2(cols[0], torch.zeros_like(cols[0]))
    tpow = None
    for col in cols[1:]:
        tpow = theta if tpow is None else gl.ext_mul(tpow, theta)
        acc = GF2(gl.add(acc.c0, gl.mul(col, tpow.c0)),
                  gl.add(acc.c1, gl.mul(col, tpow.c1)))
    return acc


def _table_col_slices(ir) -> List[Tuple[int, int]]:
    """(start, width) into the flattened table-column block, per table."""
    out = []
    ofs = 0
    for tbl in ir.lookup_tables:
        w = np.asarray(tbl).shape[1]
        out.append((ofs, w))
        ofs += w
    return out


def _chunk_products(t: GF2, num_chunks: int, chunk: int) -> GF2:
    """(nw, n) ext terms -> (C, n) products over each chunk of columns (the
    last chunk padded with ones)."""
    nw, n = t.shape
    pad = num_chunks * chunk - nw
    if pad:
        t = GF2(torch.cat([t.c0, torch.ones((pad, n), dtype=torch.int64,
                                            device=t.c0.device)]),
                torch.cat([t.c1, torch.zeros((pad, n), dtype=torch.int64,
                                             device=t.c1.device)]))
    r = t.reshape(num_chunks, chunk, n)
    acc = r[:, 0]
    for k in range(1, chunk):
        acc = gl.ext_mul(acc, r[:, k])
    return acc


# ---------------------------------------------------------------------------
# Prove-phase functions
# ---------------------------------------------------------------------------

def _chunk_blocks(C: int, copy_chunk: int, n: int):
    """(first, end) copy chunks of each block of `_block_rows` columns of n
    rows: the copy terms of a wide trace are formed one block at a time."""
    step = max(1, _block_rows(n, _COPY_BLOCK_COLS) // copy_chunk)
    return [(c, min(C, c + step)) for c in range(0, C, step)]


def _copy_block_terms(wit: GF, other: GF, ids: GF, beta: GF2, gamma: GF2,
                      c0: int, c1: int, copy_chunk: int):
    """Chunk products of (w + beta * id + gamma) and (w + beta * sigma +
    gamma) over copy chunks [c0, c1); `ids` are the block's id columns."""
    cols = slice(c0 * copy_chunk, min((c1) * copy_chunk, wit.shape[0]))
    nums = _chunk_products(_lin_term_device(wit[cols], ids, beta, gamma),
                           c1 - c0, copy_chunk)
    dens = _chunk_products(_lin_term_device(wit[cols], other[cols], beta,
                                            gamma), c1 - c0, copy_chunk)
    return nums, dens


def _stage2(witness: GF, sigma_cols: GF, beta: GF2, gamma: GF2, w_pows: GF,
            ks_vec: GF, copy_chunk: int) -> GF:
    """Copy-permutation columns (the JAX package's `_stage2_fn`): per-column
    linear terms, within-chunk products over the chunk axis (a block of
    columns at a time), cross-chunk running products (a log-depth scan over
    the chunk axis), then the grand product z over rows.

    Returns (2 * C, n) rows [z.c0, z.c1, pp_0.c0, pp_0.c1, ...]."""
    num_witness = witness.shape[0]
    C = len(_copy_chunks(num_witness, copy_chunk))
    parts = []
    for c0, c1 in _chunk_blocks(C, copy_chunk, witness.shape[-1]):
        # id_j = w_pows * k_j for the block's columns
        ids = gl.mul(w_pows[None, :], ks_vec[c0 * copy_chunk:
                                             min(c1 * copy_chunk,
                                                 num_witness), None])
        nums, dens = _copy_block_terms(witness, sigma_cols, ids, beta, gamma,
                                       c0, c1, copy_chunk)
        del ids
        parts.append(gl.ext_mul(nums, gl.ext_inv(dens)))
        del nums, dens
    ratios = gl.ext_concat(parts, axis=0)  # (C, n)
    del parts
    # inclusive running product over the chunk axis
    incl_t = _ext_scan_inclusive(GF2(ratios.c0.t(), ratios.c1.t()),
                                 gl.ext_mul)
    del ratios
    incl = GF2(incl_t.c0.t(), incl_t.c1.t())
    z_col = _ext_prefix_product_exclusive(incl[C - 1])
    # pp_c = z * prod_{t<=c} ratio_t for c in 0..C-2
    pp = gl.ext_mul(GF2(z_col.c0[None], z_col.c1[None]), incl[:C - 1])
    del incl, incl_t
    return torch.cat([torch.stack([z_col.c0, z_col.c1]),
                      torch.stack([pp.c0, pp.c1], dim=1).reshape(
                          2 * (C - 1), witness.shape[-1])])


def _stage3(ir: PlonkishIR, witness: GF, table_cols: GF, m_cols: GF,
            theta: GF2, beta_lk: GF2) -> GF:
    """Logup helper columns (the JAX package's `_stage3_fn`): rows
    [s.c0, s.c1, h_table_t..., h_set_s...]."""
    h_tables = []
    for t, (start, width) in enumerate(_table_col_slices(ir)):
        t_comp = _compress_theta(
            [table_cols[start + j] for j in range(width)], theta)
        h_tables.append(gl.ext_mul_base(
            gl.ext_inv(gl.ext_add(t_comp, beta_lk)), m_cols[t]))
    # every set's 1/(a + beta) in one batched inversion
    h_sets = gl.ext_inv(gl.ext_add(_set_compressions(ir, witness, theta),
                                   beta_lk))
    delta = gl.ext_sum_axis(h_sets, axis=0)
    for h in h_tables:
        delta = gl.ext_sub(delta, h)
    s_col = _ext_prefix_sum_exclusive(delta)
    out = [s_col.c0, s_col.c1]
    for h in h_tables:
        out.extend([h.c0, h.c1])
    return torch.cat([torch.stack(out),
                      torch.stack([h_sets.c0, h_sets.c1], dim=1).reshape(
                          -1, witness.shape[-1])])


def _set_compressions(ir: PlonkishIR, cols, theta: GF2) -> GF2:
    """(S, n) theta-compressions of the S lookup sets' witness columns
    (`cols[c]` is column c)."""
    comps = [_compress_theta([cols[c] for c in set_cols], theta)
             for _tbl, set_cols in ir.lookup_sets]
    return GF2(torch.stack([x.c0 for x in comps]),
               torch.stack([x.c1 for x in comps]))


def _ext_weighted_sum(vals: GF2, weights: GF2) -> GF2:
    """sum_i weights[i] * vals[i] over the first axis, ext by ext."""
    wb = GF2(weights.c0[:, None], weights.c1[:, None])
    return gl.ext_sum_axis(gl.ext_mul(wb, vals), axis=0)


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


class _DegAlg:
    """Degree/column-support tracing algebra.

    Values are (degree, frozenset of witness cols). Witness and const
    columns are degree-1 polynomials (deg <= n-1); scalar int constants
    are degree 0. add/sub take the max (exact upper bound), mul sums —
    conservative upper bounds, so a derived class size can only be >= the
    true requirement (never unsound)."""

    def add(self, a, b):
        return (max(a[0], b[0]), a[1] | b[1])

    sub = add

    def mul(self, a, b):
        return (a[0] + b[0], a[1] | b[1])

    def mul_int(self, a, c):
        return a

    add_int = mul_int


def derive_gate_part_meta(ir: PlonkishIR):
    """(gate_part_degrees, gate_part_cols) derived by tracing each gate
    part with _DegAlg. Use with dataclasses.replace."""
    parts = ir.eval_gates_parts or (ir.eval_gates,)
    alg = _DegAlg()
    w = [(1, frozenset([j])) for j in range(ir.num_witness)]
    c = [(1, frozenset()) for _ in range(ir.num_const)]
    degs = []
    cols = []
    for pf in parts:
        outs = pf(alg, w, w, c)
        degs.append(max([d for d, _cc in outs], default=1))
        support = frozenset().union(*[cc for _d, cc in outs]) if outs \
            else frozenset()
        cols.append(tuple(sorted(support)))
    return tuple(degs), tuple(cols)


def stratify(ir: PlonkishIR) -> PlonkishIR:
    """Opt a circuit into degree-stratified quotient evaluation with
    automatically derived per-part degrees and column support."""
    degs, cols = derive_gate_part_meta(ir)
    assert max(degs) <= ir.gate_degree, (degs, ir.gate_degree)
    return dataclasses.replace(ir, gate_part_degrees=degs,
                               gate_part_cols=cols)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _roll_next(a: GF) -> GF:
    """Cyclic next-row rotation inside a coset."""
    return torch.roll(a, -1, dims=-1)


def _coset_fn_strat(ir: PlonkishIR, lde_eval: int):
    """Degree-STRATIFIED constraint composition.

    Each constraint family's quotient contribution C(x)/Z_H(x) has degree
    < (d-1)*n for a degree-d family, so it is exactly determined by its
    values on ceil_pow2(d-1) cosets of the n-domain:

      gate part p (declared degree d_p)      -> ceil_pow2(d_p - 1) cosets
      copy chunks (degree copy_chunk + 1)    -> ceil_pow2(copy_chunk)
      lookup + boundary + PI (quotient < n)  -> ONE coset

    The per-class coefficient vectors (INTT over the class's own coset
    domain) sum to the total quotient polynomial.

    A circuit without `gate_part_degrees` gets the UNSTRATIFIED composition
    (the JAX package's `_coset_fn`): every family is put into the one class
    of size lde_eval, so each of the lde_eval cosets evaluates all gate
    parts, the copy chunks and the lookup/boundary/PI terms over all
    columns, and the one class's INTT is `_quotient_coeffs_fn`'s.

    Returns (call, class_Ds) where call(c, ...) -> {D: GF2 contribution at
    coset c} and class_Ds is the sorted set of distinct class sizes.
    """
    chunks = _copy_chunks(ir.num_witness, ir.copy_chunk)
    has_lk = bool(ir.lookup_sets)
    n_tables = len(ir.lookup_tables)
    tslices = _table_col_slices(ir)
    alg = DeviceAlgebra()
    w_gen = gl.primitive_root_of_unity(ir.log_n)
    # alpha-power layout (must match verify's sequential consumption):
    # [gates)[copy)[lookup)[boundary z][boundary s (lk)][PIs)
    G = ir.num_gate_constraints
    C = len(chunks)
    L = (len(ir.lookup_sets) + n_tables + 1) if has_lk else 0
    b_z = G + C + L
    pi_off = b_z + 1 + (1 if has_lk else 0)
    nw = ir.num_witness

    # ---- class table ----------------------------------------------------
    if ir.eval_gates_parts is not None:
        part_fns = list(ir.eval_gates_parts)
        part_counts = list(ir.gate_part_counts)
    else:
        part_fns = [ir.eval_gates]
        part_counts = [G]
    assert sum(part_counts) == G
    part_offs = [0]
    for cnt in part_counts[:-1]:
        part_offs.append(part_offs[-1] + cnt)
    if ir.gate_part_degrees is not None:
        part_degs = list(ir.gate_part_degrees)
        assert len(part_degs) == len(part_fns), "one degree per gate part"
        part_cols = (list(ir.gate_part_cols)
                     if ir.gate_part_cols is not None
                     else [None] * len(part_fns))
        part_D = [min(lde_eval, _ceil_pow2(max(1, d - 1)))
                  for d in part_degs]
        D_copy = min(lde_eval, _ceil_pow2(ir.copy_chunk))
        D_lkbp = 1
    else:
        part_cols = [None] * len(part_fns)
        part_D = [lde_eval] * len(part_fns)
        D_copy = D_lkbp = lde_eval

    lk_cols = sorted({cc for (_t, cols) in ir.lookup_sets for cc in cols})
    pi_cols = sorted({cc for (cc, _r) in ir.public_input_cells})

    # ---- per-coset roles ------------------------------------------------
    # role = (active gate parts, copy?, lkbp?); class D is active at coset
    # c iff c % (lde_eval // D) == 0 (its cosets ARE the subgroup coset
    # points s * <v^(lde/D)> interleaved into the big domain)
    roles = {}
    for c in range(lde_eval):
        act_parts = tuple(p for p in range(len(part_fns))
                          if c % (lde_eval // part_D[p]) == 0)
        copy_on = c % (lde_eval // D_copy) == 0
        lkbp_on = c % (lde_eval // D_lkbp) == 0
        roles[c] = (act_parts, copy_on, lkbp_on)

    def _role_wit_cols(role):
        act_parts, copy_on, lkbp_on = role
        need = set()
        for p in act_parts:
            if part_cols[p] is None:
                return None  # all columns
            need.update(part_cols[p])
        if copy_on:
            return None
        if lkbp_on:
            need.update(lk_cols)
            need.update(pi_cols)
        return tuple(sorted(need))

    def _weighted_sum(vals, apows, off, zh_inv, n):
        """zh_inv * sum_i alpha^(off+i) * vals[i] for base-field vals on
        (a block of rows of) a coset of n points.

        A block of values (`_block_rows`) is stacked and multiplied by
        their alpha powers in one launch per component, then summed by a
        log-depth tree: a few launches per block where one value took four.
        Field addition is exact, so the order of the sum does not change
        it."""
        c0 = c1 = None
        step = _block_rows(max((v.numel() for v in vals), default=1),
                           _WSUM_CHUNK, n)
        for s in range(0, len(vals), step):
            part = vals[s:s + step]
            shape = torch.broadcast_shapes(*(v.shape for v in part))
            blk = torch.stack([v.expand(shape) for v in part])
            a = apows[off + s:off + s + len(part)]
            ab = (-1,) + (1,) * len(shape)
            t0 = gl.sum_axis(gl.mul(blk, a.c0.reshape(ab)), axis=0)
            t1 = gl.sum_axis(gl.mul(blk, a.c1.reshape(ab)), axis=0)
            del blk
            c0 = t0 if c0 is None else gl.add(c0, t0)
            c1 = t1 if c1 is None else gl.add(c1, t1)
        return GF2(gl.mul(c0, zh_inv), gl.mul(c1, zh_inv))

    # ---- constraint family bodies ---------------------------------------
    def f_gate(p, wit_ev, const_ev, zh_inv, apows, col_sel):
        """Gate part p over the coset, a block of rows at a time: whole on
        a coset of up to `_BLOCKED_ROWS` points, else in as many blocks (a
        power of two) as `_BLOCK_BYTES` takes to hold the witness values,
        none shorter than `_BLOCKED_ROWS`, so the part's stacked
        intermediates shrink with them. Each constraint reads its row and
        the next (cyclically), so the blocks' values are the whole
        coset's."""
        n = wit_ev.shape[-1]
        nb = min(max(1, n // _BLOCKED_ROWS),
                 _ceil_pow2(-(-8 * wit_ev.numel() // _BLOCK_BYTES)))
        rows = n // nb
        out0, out1 = [], []
        for r0 in range(0, n, rows):
            r1 = r0 + rows
            cur = wit_ev[:, r0:r1]
            nxt = (_roll_next(wit_ev) if nb == 1 else
                   wit_ev[:, r0 + 1:r1 + 1] if r1 < n else
                   torch.cat([wit_ev[:, r0 + 1:], wit_ev[:, :1]], dim=-1))
            w = [None] * nw
            wn = [None] * nw
            for k, cc in enumerate(col_sel):
                w[cc] = cur[k]
                wn[cc] = nxt[k]
            const_cols_l = ([const_ev[j, r0:r1] for j in range(ir.num_const)]
                            if const_ev is not None else [])
            gate_vals = part_fns[p](alg, w, wn, const_cols_l)
            assert len(gate_vals) == part_counts[p], (len(gate_vals),
                                                      part_counts[p])
            v = _weighted_sum(gate_vals, apows, part_offs[p], zh_inv, n)
            del gate_vals, cur, nxt, w, wn
            out0.append(v.c0)
            out1.append(v.c1)
        if nb == 1:
            return GF2(out0[0], out1[0])
        return GF2(torch.cat(out0, dim=-1), torch.cat(out1, dim=-1))

    def f_copy(wit_ev, s2_ev, sigma_ev, xs, zh_inv, ks_vec, apows, beta,
               gamma):
        n = wit_ev.shape[-1]
        z_ext = GF2(s2_ev[0], s2_ev[1])
        z_next = GF2(_roll_next(s2_ev[0]), _roll_next(s2_ev[1]))
        # prev_t = [z, pp_0..pp_{C-2}]; nxt_t = [pp_0..pp_{C-2}, z_next]
        pp = s2_ev[2:2 * C]
        pps_b = GF2(pp[0::2], pp[1::2])  # (C-1, n)
        prev_b = GF2(torch.cat([z_ext.c0[None], pps_b.c0]),
                     torch.cat([z_ext.c1[None], pps_b.c1]))
        nxt_b = GF2(torch.cat([pps_b.c0, z_next.c0[None]]),
                    torch.cat([pps_b.c1, z_next.c1[None]]))
        comb = None
        for c0, c1 in _chunk_blocks(C, ir.copy_chunk, n):
            ids_b = gl.mul(xs[None, :], ks_vec[c0 * ir.copy_chunk:
                                               min(c1 * ir.copy_chunk, nw),
                                               None])
            nums_b, dens_b = _copy_block_terms(wit_ev, sigma_ev, ids_b, beta,
                                               gamma, c0, c1, ir.copy_chunk)
            del ids_b
            cv_b = gl.ext_sub(gl.ext_mul(nxt_b[c0:c1], dens_b),
                              gl.ext_mul(prev_b[c0:c1], nums_b))
            del nums_b, dens_b
            term = _ext_weighted_sum(cv_b, apows[G + c0:G + c1])
            comb = term if comb is None else gl.ext_add(comb, term)
        return gl.ext_mul_base(comb, zh_inv)

    def f_lkbp(wit_ev, s2_ev, s3_ev, table_ev, xs, zh_inv, apows, theta,
               beta_lk, pi_vals, col_sel):
        # lookup terms + boundary terms + PI terms; quotient degree < n
        n = s2_ev.shape[-1]
        wit_cols = [None] * nw
        if wit_ev is not None:
            for k, cc in enumerate(col_sel):
                wit_cols[cc] = wit_ev[k]
        comb = gl.ext_zeros((n,), s2_ev.device)
        lookup_vals: List[GF2] = []
        s_ext = None
        if has_lk:
            m_ofs = 2 + 2 * (C - 1)
            s_ext = GF2(s3_ev[0], s3_ev[1])
            s_next = GF2(_roll_next(s3_ev[0]), _roll_next(s3_ev[1]))
            h_tables = [GF2(s3_ev[2 + 2 * t], s3_ev[3 + 2 * t])
                        for t in range(n_tables)]
            h_ofs = 2 + 2 * n_tables
            S = len(ir.lookup_sets)
            h_sets = GF2(s3_ev[h_ofs:h_ofs + 2 * S:2],
                         s3_ev[h_ofs + 1:h_ofs + 2 * S:2])  # (S, n)
            # the S set terms h_s * (a_s + beta) - 1, batched, and their
            # share of the alpha combination
            one = gl.ext_ones((), s2_ev.device)
            set_vals = gl.ext_sub(gl.ext_mul(h_sets, gl.ext_add(
                _set_compressions(ir, wit_cols, theta), beta_lk)), one)
            comb = _ext_weighted_sum(set_vals, apows[G + C:G + C + S])
            del set_vals
            for t, (start, width) in enumerate(tslices):
                t_comp = _compress_theta(
                    [table_ev[start + j] for j in range(width)], theta)
                denom = gl.ext_add(t_comp, beta_lk)
                m_ext = gl.ext_from_base(s2_ev[m_ofs + t])
                lookup_vals.append(gl.ext_sub(gl.ext_mul(h_tables[t], denom),
                                              m_ext))
            s_trans = gl.ext_sub(gl.ext_sub(s_next, s_ext),
                                 gl.ext_sum_axis(h_sets, axis=0))
            for h in h_tables:
                s_trans = gl.ext_add(s_trans, h)
            lookup_vals.append(s_trans)
            # tables and the running-sum transition follow the S sets
            for i, cv in enumerate(lookup_vals):
                comb = gl.ext_add(comb, gl.ext_mul(apows[G + C + S + i], cv))
        comb = gl.ext_mul_base(comb, zh_inv)
        # boundary z(1) = 1 (and s(1) = 0 for lookups)
        z_ext = GF2(s2_ev[0], s2_ev[1])
        zm1 = GF2(gl.sub(z_ext.c0, gl.scalar_like(1, xs)), z_ext.c1)
        xm1_inv = gl.inv(gl.sub(xs, gl.scalar_like(1, xs)))
        comb = gl.ext_add(comb, gl.ext_mul(
            apows[b_z], gl.ext_mul_base(zm1, xm1_inv)))
        if has_lk:
            comb = gl.ext_add(comb, gl.ext_mul(
                apows[b_z + 1],
                gl.ext_mul_base(s_ext, xm1_inv)))
        # PI terms (w_col - pi) / (x - w^row), a block of cells
        # (`_block_rows`) at a time: the denominators of the block's
        # distinct rows inverted in one batch (row 0's is 1 / (x - 1)), the
        # terms and their alpha powers stacked
        cells = ir.public_input_cells
        step = _block_rows(n, _WSUM_CHUNK)
        for s in range(0, len(cells), step):
            part = cells[s:s + step]
            k = len(part)
            rows = sorted({row for _col, row in part} - {0})
            pos = {0: 0, **{row: j + 1 for j, row in enumerate(rows)}}
            dens = [xm1_inv[None]]
            if rows:
                pts = gl.from_int([pow(w_gen, row, P) for row in rows],
                                  xs.device).reshape(-1, 1)
                dens.append(gl.inv(gl.sub(xs[None, :], pts)))
            den = torch.cat(dens)
            del dens
            w_pi = torch.stack([wit_cols[col] for col, _row in part])
            idx = torch.tensor([pos[row] for _col, row in part],
                               device=den.device)
            term = gl.mul(gl.sub(w_pi, pi_vals[s:s + k, None]),
                          den.index_select(0, idx))
            del w_pi, den
            a = apows[pi_off + s:pi_off + s + k]
            comb = gl.ext_add(comb, GF2(
                gl.sum_axis(gl.mul(term, a.c0[:, None]), axis=0),
                gl.sum_axis(gl.mul(term, a.c1[:, None]), axis=0)))
            del term
        return comb

    def call(c, wit_coeffs, s2_coeffs, s3_coeffs, const_coeffs,
             sigma_coeffs, table_coeffs, s_c: int, zh_inv_int: int,
             u_pows, ks_vec, apows, beta, gamma, theta, beta_lk, pi_vals):
        role = roles[c]
        act_parts, copy_on, lkbp_on = role
        device = wit_coeffs.device
        n = wit_coeffs.shape[-1]
        wcols = _role_wit_cols(role)
        col_sel = tuple(range(nw)) if wcols is None else wcols

        # coset NTT of a coefficient bundle: scale by s_c^i, then NTT. Each
        # bundle's values are made just before the family that reads them
        # and let go of after it (the constants after the gates, sigma after
        # the copy terms), so no more than the witness and one family's
        # bundles are held at a time.
        pw = gl.powers(s_c, n, device=device)

        def coset_ntt(coeffs, wanted=True):
            if coeffs is None or not wanted:
                return None
            return nt.ntt(gl.mul(coeffs, pw))

        with tracing.span("coset_ntts"):
            wc = wit_coeffs if wcols is None else gl.take(
                wit_coeffs, np.array(wcols, dtype=np.int64), axis=0)
            wit_ev = coset_ntt(wc) if len(col_sel) else None
            del wc
            const_ev = coset_ntt(const_coeffs,
                                 bool(act_parts) and ir.num_const > 0)
        zh_inv = gl.from_int(zh_inv_int, device)
        xs = gl.mul_scalar(u_pows, s_c)  # the coset's points s_c * w^i
        out: Dict[int, GF2] = {}

        def add(D, v):
            out[D] = v if D not in out else gl.ext_add(out[D], v)

        with tracing.span("coset_gates"):
            for p in act_parts:
                add(part_D[p], f_gate(p, wit_ev, const_ev, zh_inv, apows,
                                      col_sel))
        del const_ev
        with tracing.span("coset_ntts"):
            s2_ev = coset_ntt(s2_coeffs, copy_on or lkbp_on)
            sigma_ev = coset_ntt(sigma_coeffs, copy_on)
        with tracing.span("coset_rest"):
            if copy_on:
                add(D_copy, f_copy(wit_ev, s2_ev, sigma_ev, xs, zh_inv,
                                   ks_vec, apows, beta, gamma))
        del sigma_ev
        with tracing.span("coset_ntts"):
            s3_ev = coset_ntt(s3_coeffs, lkbp_on and has_lk)
            table_ev = coset_ntt(table_coeffs,
                                 lkbp_on and has_lk and n_tables > 0)
        del pw
        with tracing.span("coset_rest"):
            if lkbp_on:
                add(D_lkbp, f_lkbp(wit_ev, s2_ev, s3_ev, table_ev, xs,
                                   zh_inv, apows, theta, beta_lk, pi_vals,
                                   col_sel))
        return out

    class_Ds = sorted({*part_D, D_copy, D_lkbp})
    return call, class_Ds


def _quotient_coeffs_strat(Ds: Sequence[int], num_q_chunks: int, n: int,
                           per_D_combs, unscales) -> GF:
    """Per-class coset values -> total quotient chunk columns (the JAX
    package's `_quotient_coeffs_strat_fn`).

    For each class D: interleave its D cosets into the class's own D*n
    coset domain, INTT there, unscale by shift^-i. The class coefficient
    vectors (degree < D*n each) SUM to the total quotient."""
    acc = [None, None]  # (num_q_chunks, n) coefficient rows of c0, c1
    for D, combs, unscale in zip(Ds, per_D_combs, unscales):
        k = min(D, num_q_chunks)  # rows >= num_q_chunks are zero
        for comp in range(2):
            vals = torch.stack([(cm.c0, cm.c1)[comp] for cm in combs],
                               dim=1).reshape(D * n)
            co = gl.mul(nt.intt(vals), unscale).reshape(D, n)[:k]
            if num_q_chunks - k:
                co = torch.cat([co, torch.zeros(
                    (num_q_chunks - k, n), dtype=torch.int64,
                    device=co.device)])
            acc[comp] = co if acc[comp] is None else gl.add(acc[comp], co)
    return torch.stack(acc, dim=1).reshape(2 * num_q_chunks, n)


def _deep_invs(z: GF2, zw: GF2, xs: GF):
    """1/(x-z), 1/(x-zw) over the commitment domain (shared by every
    streamed DEEP partial)."""
    inv_xz = gl.ext_inv(GF2(gl.sub(xs, z.c0), gl.neg(z.c1).expand(xs.shape)))
    inv_xzw = gl.ext_inv(GF2(gl.sub(xs, zw.c0),
                             gl.neg(zw.c1).expand(xs.shape)))
    return inv_xz, inv_xzw


def _deep_partial(deep: GF2, cols: GF, ood_z: GF2, ood_zw, gp_z: GF2, gp_zw,
                  inv_xz: GF2, inv_xzw: GF2) -> GF2:
    """One bundle's DEEP contribution, accumulated into `deep` — the DEEP
    sum is additive over bundles, so it is streamed one bundle LDE at a
    time. Term order: all at-z terms of the bundle, then (where `ood_zw` is
    given) its at-zw terms; gamma powers are sliced by the caller in the same
    global order the verifier uses."""

    def bundle(deep, g: GF2, ood: GF2, inv_den: GF2):
        # sum_j g_j (col_j - ood_j) = (dot(g.c0, cols), dot(g.c1, cols))
        #                             + sum_j g_j * (-ood_j)
        # then one ext mul by the shared inverse denominator. The dots run
        # over blocks of `_block_rows` columns (exact, so any order).
        v0 = v1 = None
        step = _block_rows(cols.shape[-1], _COPY_BLOCK_COLS)
        for j0 in range(0, cols.shape[0], step):
            blk = cols[j0:j0 + step]
            gb = g[j0:j0 + step]
            d0 = gl.sum_axis(gl.mul(blk, gb.c0[:, None]), axis=0)
            d1 = gl.sum_axis(gl.mul(blk, gb.c1[:, None]), axis=0)
            v0 = d0 if v0 is None else gl.add(v0, d0)
            v1 = d1 if v1 is None else gl.add(v1, d1)
        s = gl.ext_sum_axis(gl.ext_mul(g, gl.ext_neg(ood)), axis=0)
        tot = GF2(gl.add(v0, s.c0), gl.add(v1, s.c1))
        return gl.ext_add(deep, gl.ext_mul(tot, inv_den))

    deep = bundle(deep, gp_z, ood_z, inv_xz)
    if ood_zw is not None:
        deep = bundle(deep, gp_zw, ood_zw, inv_xzw)
    return deep


def _ext_powers(x: Tuple[int, int], k: int, device) -> GF2:
    """[x^1 .. x^k] as a GF2 vector on `device`, from exact host ints."""
    c0, c1 = [], []
    acc = (1, 0)
    for _ in range(k):
        acc = fi.emul(acc, x)
        c0.append(acc[0])
        c1.append(acc[1])
    return GF2(gl.from_int(np.array(c0, dtype=object), device),
               gl.from_int(np.array(c1, dtype=object), device))


def _ext_interleave(v: GF2) -> GF:
    """(k,) ext vector -> (2k,) base vector [c0_0, c1_0, c0_1, c1_1, ...]
    (the transcript absorb order of OOD pairs)."""
    return torch.stack([v.c0, v.c1], dim=-1).reshape(-1)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove(ir: PlonkishIR, setup: PlonkishSetup, witness: GF,
          cfg: PlonkishConfig = PlonkishConfig(), backend=None,
          backend_setup=None, device=None, mesh=None) -> PlonkishProof:
    """Prove `witness` (num_witness, n) against `setup`. `device=None` means
    the CUDA card; the witness and the setup must already live there.

    `backend`/`backend_setup` switch the Merkle hasher and the transcript to
    another hash backend (prover/hash_backend.Bn254Backend with its
    (vk_fr, setup_tree) pair): the compression-for-wrapper mode
    (prover_utils.rs:900-967). None keeps the Goldilocks Poseidon2 path.

    `mesh` (a `parallel.mesh.Mesh`, inside every rank of `run_on_mesh`)
    proves column-sharded: the witness and the setup's columns are the
    rank's shards (`parallel.mesh.prove_column_sharded`), and every rank
    returns the proof that one rank would."""
    if mesh is not None and backend is not None:
        raise NotImplementedError("a column-sharded prove has no hash "
                                  "backend (the JAX package's has none)")
    device = gl.resolve_device(device)
    for name, t in (("witness", witness), ("setup", setup.sigma_cols)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, prove runs on "
                             f"{device}")
    with tracing.span("plonkish.prove", log_n=ir.log_n,
                      num_witness=ir.num_witness):
        tracing.count("proofs")
        return _prove_impl(ir, setup, witness, cfg, device, backend,
                           backend_setup, mesh)


def _prove_impl(ir: PlonkishIR, setup: PlonkishSetup, witness: GF,
                cfg: PlonkishConfig, device: torch.device, backend=None,
                backend_setup=None, mesh=None) -> PlonkishProof:
    """The prover. With `mesh`, each rank runs it (GSPMD's placement in the
    JAX package, stated here):
      - sharded, the LDE-sized work: every commitment's coefficients-to-LDE,
        leaf hashing and subtree (`mesh.commit_bundle`; a bundle the mesh
        does not divide is committed whole in every rank), the quotient's
        cosets (rank c % D evaluates coset c, then `share_cosets`), DEEP
        (each rank's columns over the whole domain, the partial vectors
        summed) and the openings (each rank's columns at the query rows,
        the paths of the queries in its row range, gathered);
      - replicated, n rows or less: the transcript (every rank absorbs the
        same caps), stage 2 and 3's columns from the gathered witness, the
        multiplicities, the setup's coefficients, the quotient's interleave
        and INTT, the OOD evaluations, FRI on the summed DEEP vector.
    The sharded prove always streams (`RETAIN_LDE` applies to one rank)."""
    n = 1 << ir.log_n
    rate = cfg.rate
    n_comm = n * rate
    shift = gl.MULTIPLICATIVE_GENERATOR
    chunks = _copy_chunks(ir.num_witness, ir.copy_chunk)
    max_deg = max(ir.gate_degree, ir.copy_chunk + 1)
    lde_eval = 1 << (max_deg - 1).bit_length()  # eval-domain blowup
    num_q_chunks = max(1, max_deg - 1)
    has_lk = bool(ir.lookup_sets)
    n_tables = len(ir.lookup_tables)

    # commitment-domain LDEs by bundle name: filled at each commit under
    # RETAIN_LDE, left empty by the streamed schedule
    kept_ldes: Dict[str, GF] = {}
    retain = RETAIN_LDE and mesh is None

    STAGE_PEAKS.clear()

    @contextlib.contextmanager
    def stage(name: str):
        """The stage's span (with a mesh, its collectives' label too), and
        on a CUDA device its entry in `STAGE_PEAKS`."""
        with (tracing.span(name) if mesh is None else
              _both(tracing.span(name), mesh.labelled(name))):
            yield
        if device.type == "cuda":
            STAGE_PEAKS[name] = torch.cuda.max_memory_allocated(device)

    def mesh_pieces(name: str, width: int):
        """(lo, hi, split) per column range of a bundle that the mesh
        shards or replicates on its own (the setup's const, sigma and table
        columns; any other bundle whole): [lo, hi) are the columns this rank
        holds of it."""
        sizes = bundle_sizes[3:] if name == "setup" else (width,)
        out, a = [], 0
        for w in sizes:
            if w:
                lo, hi = pm.column_range(w, mesh)
                out.append((a + lo, a + hi, pm.splits(w, mesh)))
                a += w
        return out

    def mesh_query_values(name: str, coeffs_b: GF, idx: np.ndarray) -> GF:
        """(width, q) LDE values of a bundle's columns at the query rows,
        each rank's from its own columns, gathered."""
        parts = []
        for lo, hi, split in mesh_pieces(name, coeffs_b.shape[0]):
            lde_p = nt.lde_from_coeffs(coeffs_b[lo:hi], n_comm)
            v = gl.take(lde_p, idx, axis=1)
            del lde_p
            parts.append(pm.all_gather(v, mesh).reshape(-1, len(idx))
                         if split else v)
        return gl.concatenate(parts, axis=0)

    def keep(name: str, lde: GF):
        if retain:
            kept_ldes[name] = lde

    def joined(parts: List[GF]) -> GF:
        return parts[0] if len(parts) == 1 else gl.concatenate(parts, axis=0)

    def bundle_blocks(name: str, parts: List[GF]):
        """(first column, LDE) pieces of the bundle whose coefficient rows
        are `parts`, in column order: the retained LDE whole (made and kept
        where none was), else a block of `_block_rows` columns at a time,
        each released before the next is made (the whole bundle on up to
        `_BLOCKED_ROWS` points)."""
        if retain or n_comm <= _BLOCKED_ROWS:
            lde_b = kept_ldes.get(name)
            if lde_b is None:
                lde_b = nt.lde_from_coeffs(joined(parts), n_comm)
                keep(name, lde_b)
            yield 0, lde_b
            return
        off = 0
        step = _block_rows(n_comm, sum(b.shape[0] for b in parts))
        for coeffs_b in parts:
            for j in range(0, coeffs_b.shape[0], step):
                yield off + j, nt.lde_from_coeffs(coeffs_b[j:j + step],
                                                  n_comm)
            off += coeffs_b.shape[0]

    def commit(cols: GF = None, coeffs: GF = None):
        """(coefficients, LDE, tree) of a bundle given by its columns or its
        coefficients, hashed by the backend where there is one."""
        if mesh is not None:
            return pm.commit_bundle(cols, coeffs, n_comm, cfg.cap_size, mesh)
        if coeffs is None:
            coeffs = nt.intt(cols)
        if backend is None:
            lde_b, tree_b = _commit_cols_from_coeffs(coeffs, n_comm,
                                                     cfg.cap_size,
                                                     keep_lde=retain)
        else:
            lde_b = nt.lde_from_coeffs(coeffs, n_comm)
            tree_b = backend.commit_rows(lde_b, cfg.cap_size)
        return coeffs, lde_b, tree_b

    def absorb_cap(tree_b):
        if backend is None:
            tr.absorb_gf_device(tree_b.cap)
        else:
            tr.absorb_fr(tree_b.cap)

    if backend is not None:
        assert backend_setup is not None, "for-wrapper mode needs its setup"
        tr = backend.transcript()
        tr.absorb_fr(backend_setup[0])
    else:
        tr = Transcript(device=device)
        tr.absorb_ints(setup.vk())
    if mesh is not None:
        with stage("gather_inputs"):
            witness = pm.gather_columns(witness, mesh, ir.num_witness)
            setup = pm.gather_setup(setup, mesh, ir)

    # public inputs: bound via transcript + composition terms; fetch ONLY
    # the PI cells
    if ir.public_input_cells:
        ci = torch.tensor([c for c, _ in ir.public_input_cells],
                          dtype=torch.int64, device=device)
        ri = torch.tensor([r for _, r in ir.public_input_cells],
                          dtype=torch.int64, device=device)
        public_inputs = [int(v) for v in gl.to_u64(witness[ci, ri])]
    else:
        public_inputs = []
    tr.absorb_ints(public_inputs)

    def _draw_ext():
        """An extension challenge as (host int pair, device GF2 scalar)."""
        ints = tr.challenge_ext_ints()
        return ints, gl.ext_from_ints(ints[0], ints[1], device)

    # -- stage 1: witness commitment --------------------------------------
    with stage("stage1_commit"):
        wit_coeffs, wit_lde, wit_tree = commit(cols=witness)
        keep("witness", wit_lde)
        del wit_lde
        absorb_cap(wit_tree)
        _beta, beta_gf = _draw_ext()

    # -- stage 2: copy-permutation columns --------------------------------
    with stage("stage2"):
        _gamma, gamma_gf = _draw_ext()
        w_gen = gl.primitive_root_of_unity(ir.log_n)
        w_pows = gl.powers_dev_cached(w_gen, n, device=device)
        ks_vec = gl.powers_dev_cached(K_COSET_GEN, max(ir.num_witness, 1),
                                      device=device)
        stage2 = _stage2(witness, setup.sigma_cols, beta_gf, gamma_gf,
                         w_pows, ks_vec, ir.copy_chunk)
        if has_lk:
            # fetch only the lookup-set columns (not the whole witness)
            lk_cols = sorted({c for (_, cols) in ir.lookup_sets
                              for c in cols})
            sub_np = gl.to_u64(gl.take(witness,
                                       np.array(lk_cols, dtype=np.int64),
                                       axis=0))
            wit_cols_np = {c: sub_np[i] for i, c in enumerate(lk_cols)}
            with tracing.span("multiplicities"):
                m_cols_np = _multiplicities(ir, setup, wit_cols_np, n)
            m_cols = gl.from_int(np.stack(m_cols_np), device)
            stage2 = gl.concatenate([stage2, m_cols], axis=0)
        s2_coeffs, s2_lde, s2_tree = commit(cols=stage2)
        keep("stage2", s2_lde)
        del s2_lde
        absorb_cap(s2_tree)
        del stage2  # evals recomputed from coeffs per coset

    # -- stage 2b: lookup helper columns (logup with inverses) ------------
    with stage("stage3"):
        if has_lk:
            _theta, theta_gf = _draw_ext()
            _beta_lk, beta_lk_gf = _draw_ext()
            stage3 = _stage3(ir, witness, setup.table_cols, m_cols,
                             theta_gf, beta_lk_gf)
            s3_coeffs, s3_lde, s3_tree = commit(cols=stage3)
            keep("stage3", s3_lde)
            del s3_lde
            absorb_cap(s3_tree)
            del stage3
        else:
            theta_gf = beta_lk_gf = gl.ext_zeros((), device)
            s3_coeffs = s3_tree = None
    # the witness evals are dead past this point (everything downstream
    # reads wit_coeffs)
    del witness

    # -- stage 3: quotient (coset-streamed over the eval domain) ----------
    with stage("quotient_cosets"):
        alpha, _alpha_gf = _draw_ext()
        const_coeffs = nt.intt(setup.const_cols) if ir.num_const else None
        sigma_coeffs = nt.intt(setup.sigma_cols)
        table_coeffs = nt.intt(setup.table_cols) if n_tables else None

        # alpha powers in exact constraint order (matches verify)
        n_constraints = (
            ir.num_gate_constraints + len(chunks)
            + ((len(ir.lookup_sets) + n_tables + 1) if has_lk else 0)
            + 1 + (1 if has_lk else 0) + len(ir.public_input_cells))
        apows = _ext_powers(alpha, n_constraints, device)

        n_eval = n * lde_eval
        v = gl.primitive_root_of_unity(n_eval.bit_length() - 1)
        u = pow(v, lde_eval, P)
        u_pows = gl.powers_dev_cached(u, n, device=device)
        pi_vals = gl.from_int(np.array(public_inputs, dtype=object), device)
        bundle_sizes = (
            wit_coeffs.shape[0], s2_coeffs.shape[0],
            s3_coeffs.shape[0] if s3_coeffs is not None else 0,
            const_coeffs.shape[0] if const_coeffs is not None else 0,
            sigma_coeffs.shape[0],
            table_coeffs.shape[0] if table_coeffs is not None else 0)
        scall, class_Ds = _coset_fn_strat(ir, lde_eval)
        acc: Dict[int, List] = {D: [None] * D for D in class_Ds}
        for c in range(lde_eval):
            if all(c % (lde_eval // D) for D in class_Ds):
                continue  # no class needs this coset
            if mesh is not None and c % mesh.size != mesh.rank:
                continue  # another rank's coset
            s_c = (shift * pow(v, c, P)) % P
            zh_c = (pow(s_c, n, P) - 1) % P
            res = scall(
                c, wit_coeffs, s2_coeffs, s3_coeffs, const_coeffs,
                sigma_coeffs, table_coeffs, s_c, pow(zh_c, P - 2, P),
                u_pows, ks_vec, apows, beta_gf, gamma_gf, theta_gf,
                beta_lk_gf, pi_vals)
            for D, val in res.items():
                acc[D][c // (lde_eval // D)] = val
        if mesh is not None:
            pm.share_cosets(acc, class_Ds, lde_eval, n, mesh)

    with stage("quotient_commit"):
        unscales = [gl.powers_dev_cached(pow(shift, P - 2, P), D * n,
                                         device=device) for D in class_Ds]
        q_coeffs = _quotient_coeffs_strat(
            class_Ds, num_q_chunks, n, [acc[D] for D in class_Ds], unscales)
        del acc
        _q, q_lde, q_tree = commit(coeffs=q_coeffs)
        keep("quotient", q_lde)
        del q_lde
        absorb_cap(q_tree)

    # -- stage 4: OOD evaluations -----------------------------------------
    with stage("ood"):
        z_pt, z_gf = _draw_ext()
        zw_gf = gl.ext_from_ints(*fi.escale(z_pt, w_gen), device)

        ev_specs = [("witness", wit_coeffs, z_gf), ("stage2", s2_coeffs, z_gf),
                    ("stage3", s3_coeffs, z_gf), ("const", const_coeffs, z_gf),
                    ("sigma", sigma_coeffs, z_gf),
                    ("table", table_coeffs, z_gf),
                    ("quotient", q_coeffs, z_gf),
                    ("witness_next", wit_coeffs, zw_gf),
                    ("stage2_next", s2_coeffs, zw_gf),
                    ("stage3_next", s3_coeffs, zw_gf)]
        ev_dev = {name: (nt.eval_poly_at(coeffs, pt) if coeffs is not None
                         else None) for name, coeffs, pt in ev_specs}
        # transcript absorb order (must match verify): witness,
        # witness_next, stage2, stage2_next, stage3, stage3_next, table,
        # const, sigma, quotient
        _absorb_order = ["witness", "witness_next", "stage2", "stage2_next",
                         "stage3", "stage3_next", "table", "const", "sigma",
                         "quotient"]
        tr.absorb_gf_device(_ext_interleave(gl.ext_concat(
            [ev_dev[k] for k in _absorb_order if ev_dev[k] is not None])))

    # -- stage 5: DEEP + FRI ----------------------------------------------
    with stage("deep"):
        gamma_deep, _gd_gf = _draw_ext()
        # the setup bundle's coefficient rows, its const, sigma and table
        # columns in that order
        setup_parts = [b for b in (const_coeffs, sigma_coeffs, table_coeffs)
                       if b is not None]
        del const_coeffs, sigma_coeffs, table_coeffs
        ood_setup_dev = gl.ext_concat(
            [ev_dev[k] for k in ("const", "sigma", "table")
             if ev_dev[k] is not None])
        s2_w = bundle_sizes[1]
        s3_w = bundle_sizes[2]
        setup_w = bundle_sizes[3] + bundle_sizes[4] + bundle_sizes[5]
        n_deep_terms = (2 * ir.num_witness + 2 * s2_w
                        + (2 * s3_w if has_lk else 0)
                        + setup_w + 2 * num_q_chunks)
        gpows = _ext_powers(gamma_deep, n_deep_terms, device)
        xs = gl.powers_dev_cached(
            gl.primitive_root_of_unity(n_comm.bit_length() - 1), n_comm,
            mult=shift, device=device)
        # DEEP is additive over bundles: each commitment LDE (retained, or
        # recomputed from its coefficients and released) is folded into the
        # accumulator in turn. The retained schedule of the JAX package sums
        # the same terms column by column (`_deep_fn`); the sums are exact,
        # so one accumulation serves both schedules. The gamma-power order
        # matches the verifier exactly.
        inv_xz, inv_xzw = _deep_invs(z_gf, zw_gf, xs)
        deep = gl.ext_zeros((n_comm,), device)
        # with a mesh: the terms of the columns the mesh shards, which the
        # ranks sum at the end (`deep` takes the replicated ones)
        deep_sharded = (None if mesh is None
                        else gl.ext_zeros((n_comm,), device))
        stream = [("witness", [wit_coeffs], ev_dev["witness"],
                   ev_dev["witness_next"]),
                  ("stage2", [s2_coeffs], ev_dev["stage2"],
                   ev_dev["stage2_next"])]
        if has_lk:
            stream.append(("stage3", [s3_coeffs], ev_dev["stage3"],
                           ev_dev["stage3_next"]))
        stream += [("setup", setup_parts, ood_setup_dev, None),
                   ("quotient", [q_coeffs], ev_dev["quotient"], None)]
        gp_off = 0
        for name, parts, ood_z, ood_zw in stream:
            w_b = sum(b.shape[0] for b in parts)
            gp_z = gpows[gp_off:gp_off + w_b]
            gp_off += w_b
            if ood_zw is not None:
                gp_zw = gpows[gp_off:gp_off + w_b]
                gp_off += w_b
            else:
                gp_zw = None
            if mesh is None:
                # the bundle's terms a block of columns at a time
                for lo, lde_b in bundle_blocks(name, parts):
                    hi = lo + lde_b.shape[0]
                    deep = _deep_partial(
                        deep, lde_b, ood_z[lo:hi],
                        None if ood_zw is None else ood_zw[lo:hi],
                        gp_z[lo:hi], None if gp_zw is None else gp_zw[lo:hi],
                        inv_xz, inv_xzw)
                    del lde_b
                continue
            coeffs_b = joined(parts)
            for lo, hi, split in mesh_pieces(name, w_b):
                lde_p = nt.lde_from_coeffs(coeffs_b[lo:hi], n_comm)
                part = _deep_partial(
                    deep_sharded if split else deep, lde_p, ood_z[lo:hi],
                    None if ood_zw is None else ood_zw[lo:hi],
                    gp_z[lo:hi], None if gp_zw is None else gp_zw[lo:hi],
                    inv_xz, inv_xzw)
                if split:
                    deep_sharded = part
                else:
                    deep = part
                del lde_p
        assert gp_off == n_deep_terms
        del inv_xz, inv_xzw
        if mesh is not None:
            deep = gl.ext_add(deep, pm.sum_over_ranks(deep_sharded, mesh))
        del deep_sharded

    fri_cfg = cfg.fri_config(n_comm)
    with stage("fri"):
        fri_proof = fri_prove(deep, shift, tr, fri_cfg, backend=backend)
    del deep

    def _pairs(name):
        e = ev_dev.get(name)
        if e is None:
            return []
        return [(int(a), int(b)) for a, b in
                zip(np.atleast_1d(gl.to_u64(e.c0)),
                    np.atleast_1d(gl.to_u64(e.c1)))]

    # -- stage 6: query openings ------------------------------------------
    with stage("openings"):
        h0 = n_comm // 2
        idx_set = sorted({int(p) % h0 for p in fri_proof.query_positions} |
                         {int(p) % h0 + h0 for p in fri_proof.query_positions})
        idx_arr = np.array(idx_set, dtype=np.uint32)
        openings: Dict[str, Dict[int, List[int]]] = {}
        paths: Dict[str, Dict[int, np.ndarray]] = {}
        # one bundle's LDE at a time for the query gathers
        all_trees = [("witness", [wit_coeffs], wit_tree),
                     ("stage2", [s2_coeffs], s2_tree),
                     ("quotient", [q_coeffs], q_tree),
                     ("setup", setup_parts,
                      setup.tree if backend is None else backend_setup[1])]
        if has_lk:
            all_trees.insert(2, ("stage3", [s3_coeffs], s3_tree))
        for name, parts, tree in all_trees:
            if mesh is None:
                vals = gl.to_u64(joined(
                    [gl.take(lde_b, idx_arr, axis=1)
                     for _lo, lde_b in bundle_blocks(name, parts)]).t())
            else:
                vals = gl.to_u64(mesh_query_values(name, joined(parts),
                                                   idx_arr).t())
            if isinstance(tree, pm.ShardedTree):
                pth = gl.to_u64(pm.open_sharded(tree, idx_arr, mesh))
            elif backend is None:
                pth = gl.to_u64(mk.open_indices(tree, idx_arr))
            else:
                pth = backend.open(tree, idx_set)
            openings[name] = {int(i): [int(v) for v in vals[k]]
                              for k, i in enumerate(idx_set)}
            paths[name] = {int(i): pth[k] for k, i in enumerate(idx_set)}

    if backend is None:
        cap_of = gl.to_u64
        no_cap = np.zeros((0, 4), dtype=object)
    else:
        def cap_of(c):
            return np.asarray(c, dtype=object)
        no_cap = np.zeros((0,), dtype=object)
    return PlonkishProof(
        public_inputs=public_inputs,
        witness_cap=cap_of(wit_tree.cap),
        stage2_cap=cap_of(s2_tree.cap),
        quotient_cap=cap_of(q_tree.cap),
        ood_witness=_pairs("witness"),
        ood_witness_next=_pairs("witness_next"),
        ood_stage2=_pairs("stage2"), ood_stage2_next=_pairs("stage2_next"),
        stage3_cap=cap_of(s3_tree.cap) if has_lk else no_cap,
        ood_stage3=_pairs("stage3"),
        ood_stage3_next=_pairs("stage3_next"), ood_table=_pairs("table"),
        ood_const=_pairs("const"), ood_sigma=_pairs("sigma"),
        ood_quotient=_pairs("quotient"),
        openings=openings, paths=paths, fri=fri_proof)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def _verify_inner(ir: PlonkishIR, vk: List[int], proof: PlonkishProof,
                  cfg: PlonkishConfig = PlonkishConfig(),
                  device=None, backend=None) -> bool:
    """With `backend` set, `vk` is the backend-hashed setup cap (Fr list for
    Bn254Backend) and all caps/paths are backend digests."""
    device = gl.resolve_device(device)
    n = 1 << ir.log_n
    rate = cfg.rate
    n_comm = n * rate
    shift = gl.MULTIPLICATIVE_GENERATOR
    chunks = _copy_chunks(ir.num_witness, ir.copy_chunk)
    max_deg = max(ir.gate_degree, ir.copy_chunk + 1)
    num_q_chunks = max(1, max_deg - 1)
    w_gen = gl.primitive_root_of_unity(ir.log_n)

    if backend is not None:
        tr = backend.transcript()
        tr.absorb_fr(vk)
    else:
        tr = Transcript(device=device)
        tr.absorb_ints(vk)
    if len(proof.public_inputs) != len(ir.public_input_cells):
        return False
    # Geometry binding: every absorbed OOD list and every opened row must
    # have exactly the width implied by the circuit IR (a prover-chosen
    # width would leave absorbed values unbound by DEEP).
    n_tables_chk = len(ir.lookup_tables)
    s2_width = 2 + 2 * (len(chunks) - 1) + n_tables_chk
    s3_width = (2 + 2 * n_tables_chk + 2 * len(ir.lookup_sets)
                if ir.lookup_sets else 0)
    table_width = sum(np.asarray(t).shape[1] for t in ir.lookup_tables)
    widths_ok = (
        len(proof.ood_witness) == ir.num_witness
        and len(proof.ood_witness_next) == ir.num_witness
        and len(proof.ood_stage2) == s2_width
        and len(proof.ood_stage2_next) == s2_width
        and len(proof.ood_stage3) == s3_width
        and len(proof.ood_stage3_next) == s3_width
        and len(proof.ood_table) == table_width
        and len(proof.ood_const) == ir.num_const
        and len(proof.ood_sigma) == ir.num_witness
        and len(proof.ood_quotient) == 2 * num_q_chunks)
    if not widths_ok:
        return False
    row_widths = {"witness": ir.num_witness, "stage2": s2_width,
                  "quotient": 2 * num_q_chunks,
                  "setup": ir.num_const + ir.num_witness + table_width}
    if ir.lookup_sets:
        row_widths["stage3"] = s3_width
    if set(proof.openings.keys()) != set(row_widths.keys()):
        return False
    open_keys = None
    for name, width in row_widths.items():
        keys = set(proof.openings[name].keys())
        if open_keys is None:
            open_keys = keys
        if keys != open_keys or set(proof.paths[name].keys()) != open_keys:
            return False
        for i in keys:
            if len(proof.openings[name][i]) != width:
                return False

    def _absorb_cap(cap):
        flat = [int(v) for v in np.asarray(cap, dtype=object).ravel()]
        if backend is not None:
            tr.absorb_fr(flat)
        else:
            tr.absorb_ints(flat)

    tr.absorb_ints([int(v) for v in proof.public_inputs])
    _absorb_cap(proof.witness_cap)
    beta = tr.challenge_ext_ints()
    gamma = tr.challenge_ext_ints()
    _absorb_cap(proof.stage2_cap)
    has_lk = bool(ir.lookup_sets)
    n_tables = len(ir.lookup_tables)
    if has_lk:
        theta = tr.challenge_ext_ints()
        beta_lk = tr.challenge_ext_ints()
        _absorb_cap(proof.stage3_cap)
    alpha = tr.challenge_ext_ints()
    _absorb_cap(proof.quotient_cap)
    z_pt = tr.challenge_ext_ints()
    zw = fi.escale(z_pt, w_gen)
    tr.absorb_ints([v for pair in
                    (proof.ood_witness + proof.ood_witness_next
                     + proof.ood_stage2 + proof.ood_stage2_next
                     + proof.ood_stage3 + proof.ood_stage3_next
                     + proof.ood_table + proof.ood_const + proof.ood_sigma
                     + proof.ood_quotient) for v in pair])
    gamma_deep = tr.challenge_ext_ints()

    # -- OOD identity ------------------------------------------------------
    alg = HostExtAlgebra()
    gate_vals = ir.eval_gates(alg, proof.ood_witness, proof.ood_witness_next,
                              proof.ood_const)
    z_ood = proof.ood_stage2[0:2]
    z_ext = fi.eadd(z_ood[0], fi.emul((0, 1), z_ood[1]))
    zn_ood = proof.ood_stage2_next[0:2]
    z_next = fi.eadd(zn_ood[0], fi.emul((0, 1), zn_ood[1]))
    pp_ext = []
    for t in range(len(chunks) - 1):
        p0 = proof.ood_stage2[2 + 2 * t]
        p1 = proof.ood_stage2[3 + 2 * t]
        pp_ext.append(fi.eadd(p0, fi.emul((0, 1), p1)))

    ks = gl.powers_host(K_COSET_GEN, max(ir.num_witness, 1)).astype(object)
    copy_vals = []
    prev = z_ext
    for t, chunk in enumerate(chunks):
        num_p = (1, 0)
        den_p = (1, 0)
        for j in chunk:
            w_j = proof.ood_witness[j]
            id_term = fi.eadd(
                fi.eadd(w_j, fi.escale(fi.emul(beta, z_pt), int(ks[j]))),
                gamma)
            sg_term = fi.eadd(
                fi.eadd(w_j, fi.emul(beta, proof.ood_sigma[j])), gamma)
            num_p = fi.emul(num_p, id_term)
            den_p = fi.emul(den_p, sg_term)
        nxt = pp_ext[t] if t < len(chunks) - 1 else z_next
        copy_vals.append(fi.esub(fi.emul(nxt, den_p), fi.emul(prev, num_p)))
        prev = pp_ext[t] if t < len(chunks) - 1 else None

    # lookup constraint values at z
    lookup_vals = []
    s_ext_lk = None
    if has_lk:
        def _pair_ext(pairs, i):
            return fi.eadd(pairs[2 * i], fi.emul((0, 1), pairs[2 * i + 1]))

        s_ext_lk = _pair_ext(proof.ood_stage3, 0)
        s_next_lk = fi.eadd(proof.ood_stage3_next[0],
                            fi.emul((0, 1), proof.ood_stage3_next[1]))
        h_tables = [_pair_ext(proof.ood_stage3, 1 + t)
                    for t in range(n_tables)]
        h_sets = [_pair_ext(proof.ood_stage3, 1 + n_tables + s)
                  for s in range(len(ir.lookup_sets))]
        m_ofs = 2 + 2 * (len(chunks) - 1)
        tslices = _table_col_slices(ir)

        def _compress_ood(vals, theta_c):
            acc = vals[0]
            tp = (1, 0)
            for v2 in vals[1:]:
                tp = fi.emul(tp, theta_c)
                acc = fi.eadd(acc, fi.emul(tp, v2))
            return acc

        for s, (_tbl, cols) in enumerate(ir.lookup_sets):
            a_comp = _compress_ood([proof.ood_witness[c] for c in cols],
                                   theta)
            denom = fi.eadd(a_comp, beta_lk)
            lookup_vals.append(fi.esub(fi.emul(h_sets[s], denom), (1, 0)))
        for t, (start, width) in enumerate(tslices):
            t_comp = _compress_ood([proof.ood_table[start + j]
                                    for j in range(width)], theta)
            denom = fi.eadd(t_comp, beta_lk)
            m_val = proof.ood_stage2[m_ofs + t]
            lookup_vals.append(fi.esub(fi.emul(h_tables[t], denom), m_val))
        s_trans = fi.esub(s_next_lk, s_ext_lk)
        for h in h_sets:
            s_trans = fi.esub(s_trans, h)
        for h in h_tables:
            s_trans = fi.eadd(s_trans, h)
        lookup_vals.append(s_trans)

    comb = (0, 0)
    apow = (1, 0)
    for gv in gate_vals:
        apow = fi.emul(apow, alpha)
        comb = fi.eadd(comb, fi.emul(apow, gv))
    for cv in copy_vals + lookup_vals:
        apow = fi.emul(apow, alpha)
        comb = fi.eadd(comb, fi.emul(apow, cv))
    zn = fi.epow(z_pt, n)
    zh = fi.esub(zn, (1, 0))
    comb = fi.emul(comb, fi.einv(zh))
    apow_b = fi.emul(apow, alpha)
    zm1 = fi.esub(z_ext, (1, 0))
    comb = fi.eadd(comb, fi.emul(
        apow_b, fi.emul(zm1, fi.einv(fi.esub(z_pt, (1, 0))))))
    if has_lk:
        apow_b = fi.emul(apow_b, alpha)
        comb = fi.eadd(comb, fi.emul(
            apow_b, fi.emul(s_ext_lk, fi.einv(fi.esub(z_pt, (1, 0))))))
    apow_pi = apow_b
    for (col, row), value in zip(ir.public_input_cells, proof.public_inputs):
        apow_pi = fi.emul(apow_pi, alpha)
        pt = pow(w_gen, row, P)
        num = fi.esub(proof.ood_witness[col], (int(value) % P, 0))
        comb = fi.eadd(comb, fi.emul(
            apow_pi, fi.emul(num, fi.einv(fi.esub(z_pt, (pt, 0))))))

    expected = (0, 0)
    zjn = (1, 0)
    for j in range(num_q_chunks):
        q0 = proof.ood_quotient[2 * j]
        q1 = proof.ood_quotient[2 * j + 1]
        qz = fi.eadd(q0, fi.emul((0, 1), q1))
        expected = fi.eadd(expected, fi.emul(zjn, qz))
        zjn = fi.emul(zjn, zn)
    if comb != expected:
        return False

    # -- Merkle openings ---------------------------------------------------
    caps = {"witness": proof.witness_cap, "stage2": proof.stage2_cap,
            "quotient": proof.quotient_cap,
            "setup": (np.array(vk, dtype=object) if backend is not None
                      else np.array(vk, dtype=object).reshape(-1, 4))}
    tree_names = ["witness", "stage2", "quotient", "setup"]
    if has_lk:
        caps["stage3"] = proof.stage3_cap
        tree_names.insert(2, "stage3")
    idx_list = sorted(proof.openings["witness"].keys())
    idx_arr = np.array(idx_list, dtype=np.uint32)
    for name in tree_names:
        if backend is not None:
            rows_t = gl.from_int(np.array(
                [proof.openings[name][i] for i in idx_list], dtype=object),
                device).t()
            pth_np = np.stack([np.asarray(proof.paths[name][i], dtype=object)
                               for i in idx_list])
            if not backend.verify_paths(
                    backend.hash_rows(rows_t), idx_list, pth_np,
                    [int(v) for v in
                     np.asarray(caps[name], dtype=object).ravel()]):
                return False
            continue
        rows = gl.from_int(np.array(
            [proof.openings[name][i] for i in idx_list], dtype=object),
            device)
        pth = gl.from_int(np.stack(
            [np.asarray(proof.paths[name][i], dtype=object)
             for i in idx_list]), device)
        cap_gf = gl.from_int(np.asarray(caps[name], dtype=object), device)
        ok = mk.verify_paths(mk.hash_leaves(rows), idx_arr, pth, cap_gf,
                             n_leaves=n_comm, cap_size=cfg.cap_size)
        if not bool(ok.all()):
            return False

    # -- DEEP recomputation at queried points ------------------------------
    log_nc = n_comm.bit_length() - 1
    v = gl.primitive_root_of_unity(log_nc)
    ood_setup = proof.ood_const + proof.ood_sigma + proof.ood_table

    def deep_at(idx: int):
        x = (shift * pow(v, idx, P)) % P
        acc = (0, 0)
        gpow = (1, 0)
        inv_xz = fi.einv(fi.esub((x, 0), z_pt))
        inv_xzw = fi.einv(fi.esub((x, 0), zw))
        groups = [
            (proof.openings["witness"][idx], proof.ood_witness, inv_xz),
            (proof.openings["witness"][idx], proof.ood_witness_next, inv_xzw),
            (proof.openings["stage2"][idx], proof.ood_stage2, inv_xz),
            (proof.openings["stage2"][idx], proof.ood_stage2_next, inv_xzw),
        ]
        if has_lk:
            groups.append((proof.openings["stage3"][idx], proof.ood_stage3,
                           inv_xz))
            groups.append((proof.openings["stage3"][idx],
                           proof.ood_stage3_next, inv_xzw))
        groups += [
            (proof.openings["setup"][idx], ood_setup, inv_xz),
            (proof.openings["quotient"][idx], proof.ood_quotient, inv_xz),
        ]
        for row, oods, inv_den in groups:
            for j in range(len(oods)):
                gpow = fi.emul(gpow, gamma_deep)
                num = fi.esub((row[j], 0), oods[j])
                acc = fi.eadd(acc, fi.emul(gpow, fi.emul(num, inv_den)))
        return acc

    fri_cfg = cfg.fri_config(n_comm)
    return fri_verify(proof.fri, n_comm, shift, tr, fri_cfg, deep_at,
                      backend=backend)


def verify(ir: PlonkishIR, vk: List[int], proof: PlonkishProof,
           cfg: PlonkishConfig = PlonkishConfig(), device=None,
           strict: bool = None, backend=None) -> bool:
    """Structural-error-tolerant wrapper: a malformed proof (wrong lengths,
    bad types, truncated openings) must REJECT, not crash the verifier.
    `strict=True` (or env ZKEVM_VERIFY_STRICT=1) re-raises instead, so
    internal invariant bugs cannot hide behind "proof rejected".

    `device=None` means the CUDA card and raises where there is none, before
    any proof data is read."""
    from .guard import tolerant_verify
    device = gl.resolve_device(device)
    return tolerant_verify(_verify_inner, ir, vk, proof, cfg, device,
                           backend, strict=strict)
