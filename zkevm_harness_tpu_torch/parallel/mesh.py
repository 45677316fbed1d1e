"""Column sharding of the proving pipeline over ranks of torch.distributed.

Counterpart of the JAX package's `parallel/mesh.py`. There one controller
drives a device mesh through shard_map, and GSPMD inserts the collectives of
a sharded prove. PyTorch's idiom for several cards is one process per rank:
every function here runs inside each rank, on the rank's local shard, and
returns the rank's local result. `run_on_mesh` is the one-process entry: it
spawns the ranks, runs a function in each and returns every rank's result.

Layout (the JAX module's):
  - witness and LDE COLUMNS are sharded over the ranks in contiguous blocks;
    an array whose column count the mesh does not divide is replicated;
  - Merkle leaf hashing needs whole rows: one all_to_all hands each rank its
    contiguous row range of every column (the JAX module all_gathers the
    columns and slices its rows out: the same digests, at D times the
    memory); each rank hashes its rows and builds its subtree down to
    cap_size / D nodes, and the cap is all_gathered.

Backend, chosen once by `run_on_mesh` before `init_process_group`: "nccl"
with one rank per card where the machine has at least as many cards as
ranks; "gloo" with every rank on card 0 where it has fewer; "gloo" on the
CPU for `device="cpu"`. A collective that fails raises; nothing falls back.

`SENT_BYTES[label][kind]` counts the bytes this rank sent, per collective
kind, under the label of the prover phase that sent them (`Mesh.label`):
all_gather D - 1 copies of the rank's part, all_to_all the (D - 1) / D of
its input that leaves the rank, broadcast D - 1 copies at the source.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import cuda_kernels as ck
from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import poseidon2 as p2
from ..ops.goldilocks import GF, GF2


@dataclasses.dataclass
class Mesh:
    """One rank's view of a one-axis mesh of `size` ranks."""

    size: int
    rank: int
    device: torch.device
    backend: str
    axis: str = "col"
    group: Optional[dist.ProcessGroup] = None  # None: the default group
    label: str = "other"  # prover phase the collectives are counted under

    @contextlib.contextmanager
    def labelled(self, label: str):
        outer, self.label = self.label, label
        try:
            yield self
        finally:
            self.label = outer


SENT_BYTES: Dict[str, Dict[str, int]] = {}


def reset_sent_bytes() -> None:
    SENT_BYTES.clear()


def _count(mesh: Mesh, kind: str, nbytes: int) -> None:
    per = SENT_BYTES.setdefault(mesh.label, {})
    per[kind] = per.get(kind, 0) + int(nbytes)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(D, *x.shape): every rank's `x`, in rank order."""
    x = x.contiguous()
    if mesh.size == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    _count(mesh, "all_gather", x.numel() * x.element_size() * (mesh.size - 1))
    return torch.stack(parts)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x of shape (D, ...): x[j] goes to rank j; returns y with y[i] the
    part rank i sent here."""
    x = x.contiguous()
    assert x.shape[0] == mesh.size
    if mesh.size == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    _count(mesh, "all_to_all",
           x.numel() * x.element_size() * (mesh.size - 1) // mesh.size)
    return out


def broadcast(x: torch.Tensor, src: int, mesh: Mesh) -> torch.Tensor:
    """`x` of rank `src` in every rank (other ranks pass a buffer of its
    shape)."""
    x = x.contiguous()
    if mesh.size == 1:
        return x
    dist.broadcast(x, src, group=mesh.group)
    if mesh.rank == src:
        _count(mesh, "broadcast",
               x.numel() * x.element_size() * (mesh.size - 1))
    return x


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

# the device `run_on_mesh` gave this process's rank (set in the rank only)
_RANK_DEVICE: Optional[torch.device] = None


def choose_backend(n: int, device=None) -> Tuple[str, str]:
    """(backend, placement) for `n` ranks: placement "cpu", "per_card"
    (rank r on card r) or "card0" (every rank on card 0)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu"
    gl.resolve_device(None)  # raises where there is no card
    if torch.cuda.device_count() >= n:
        return "nccl", "per_card"
    return "gloo", "card0"


def _rank_device(placement: str, rank: int) -> torch.device:
    if placement == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if placement == "per_card" else 0)


def _rank_main(rank, fn, n, backend, placement, tmp, timeout_s,
               launches_file, args):
    global _RANK_DEVICE
    _RANK_DEVICE = _rank_device(placement, rank)
    if _RANK_DEVICE.type == "cuda":
        torch.cuda.set_device(_RANK_DEVICE)
    else:
        # ranks on the CPU share its cores: n ranks of a full set of threads
        # each spin against each other (a (130, 2^12) distributed NTT over 4
        # ranks took 21 s so, 0.09 s with 2 threads a rank on 8 cores)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rdzv"),
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        # NCCL binds the rank's card (else it guesses it from the rank)
        device_id=_RANK_DEVICE if backend == "nccl" else None)
    try:
        result = fn(*args)
        if _RANK_DEVICE.type == "cuda":
            torch.cuda.synchronize(_RANK_DEVICE)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        if launches_file:
            ck._dump_launches(f"{launches_file}.rank{rank}")
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn, n: int, *args, device=None, timeout_s: float = 600,
                same=None):
    """Run `fn(*args)` in each of `n` ranks and return the ranks' results,
    in rank order.

    `fn` must be a module-level function (the ranks are started with
    `spawn`, which imports it by name); it builds its mesh with
    `make_mesh()`. `device=None` runs the ranks on the CUDA card(s) and
    raises where there is none; `"cpu"` runs them on the CPU over gloo.
    The kernels are built here, once, before any rank starts; the ranks
    only load them. `timeout_s` bounds every collective: a rank that dies
    leaves the others waiting no longer. A rank's exception fails the call.
    With `same` (a function of a result), the call also fails unless every
    rank's result gives the same value. With ZKEVM_LAUNCHES_FILE set, rank
    r writes its launch counts to that path + ".rank{r}"."""
    backend, placement = choose_backend(n, device)
    if placement != "cpu":
        ck.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks must not inherit the variable: at exit each would write
        # its counts to the one file
        launches_file = os.environ.pop("ZKEVM_LAUNCHES_FILE", None)
        try:
            ctx = mp.start_processes(
                _rank_main, args=(fn, n, backend, placement, tmp, timeout_s,
                                  launches_file, args),
                nprocs=n, join=False, start_method="spawn")
        finally:
            if launches_file is not None:
                os.environ["ZKEVM_LAUNCHES_FILE"] = launches_file
        while not ctx.join():
            pass
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              map_location="cpu", weights_only=False)
                   for r in range(n)]
    if same is not None:
        first = same(results[0])
        for r, res in enumerate(results[1:], 1):
            if same(res) != first:
                raise RuntimeError(f"rank {r}'s result differs from rank 0's")
    return results


def make_mesh(n_devices: Optional[int] = None, axis: str = "col",
              device=None) -> Mesh:
    """This rank's mesh over the group `run_on_mesh` initialised (every
    rank of it: `n_devices`, where given, must be the group's size)."""
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group "
                         f"has {size} ranks")
    if device is None:
        device = _RANK_DEVICE if _RANK_DEVICE is not None \
            else gl.resolve_device(None)
    return Mesh(size=size, rank=dist.get_rank(), device=torch.device(device),
                backend=dist.get_backend(), axis=axis)


# ---------------------------------------------------------------------------
# The JAX module's functions, each on the rank's shard
# ---------------------------------------------------------------------------

def splits(width: int, mesh: Mesh) -> bool:
    """The JAX rule: `width` columns are sharded iff the mesh divides it."""
    return width % mesh.size == 0


def column_range(width: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) of the columns this rank holds of a `width`-column array."""
    if not splits(width, mesh):
        return 0, width
    blk = width // mesh.size
    return mesh.rank * blk, (mesh.rank + 1) * blk


def shard_columns(x: GF, mesh: Mesh) -> GF:
    """The rank's contiguous block of a (num_cols, n) array's columns, or
    the whole array where the mesh does not divide its column count."""
    lo, hi = column_range(x.shape[0], mesh)
    return x[lo:hi]


def gather_columns(x: GF, mesh: Mesh, width: int) -> GF:
    """Inverse of `shard_columns` for an array of `width` columns."""
    if x.shape[0] == width:
        return x
    return all_gather(x, mesh).reshape((width,) + tuple(x.shape[1:]))


def sharded_coset_lde(trace: GF, lde_factor: int, mesh: Mesh) -> GF:
    """Column-sharded coset LDE: the rank's (W/D, N) block -> (W/D,
    N * lde_factor). No collective."""
    return nt.coset_lde(trace, lde_factor)


def _rows_of_columns(cols: GF, mesh: Mesh) -> GF:
    """The rank's (W/D, N) column block -> (N/D, W): its contiguous row
    range of every column (one all_to_all)."""
    wl, n = cols.shape
    d = mesh.size
    send = cols.reshape(wl, d, n // d).transpose(0, 1)  # [j]: rank j's rows
    recv = all_to_all(send, mesh)  # [i]: rank i's columns at these rows
    return recv.reshape(d * wl, n // d).t()


def sharded_leaf_hash(col_lde: GF, mesh: Mesh) -> GF:
    """The rank's (W/D, N_lde) columns -> (N_lde/D, 4) leaf digests of its
    contiguous row range."""
    return mk.hash_leaves(_rows_of_columns(col_lde, mesh))


def sharded_poseidon_throughput_step(states: GF, mesh: Mesh) -> GF:
    """Batch-sharded Poseidon2 permutation (the rank's (B/D, 12) states)."""
    return p2.permute(states)


class ShardedTree(NamedTuple):
    """A Merkle tree over leaves sharded in contiguous row ranges: this
    rank's subtree (leaves `row0` .. `row0 + len(levels[0])`, down to
    cap_size / D nodes) and the whole cap."""

    sub: mk.MerkleTree
    cap: GF
    row0: int

    @property
    def levels(self):
        return self.sub.levels


def commit_rows_sharded(lde: GF, cap_size: int, mesh: Mesh) -> ShardedTree:
    """Merkle commitment of the rows of a column-sharded (W/D, N) LDE."""
    digests = sharded_leaf_hash(lde, mesh)
    sub = mk.build_tree(digests, cap_size // mesh.size)
    cap = all_gather(sub.cap, mesh).reshape(cap_size, mk.DIGEST_WIDTH)
    return ShardedTree(sub, cap, mesh.rank * digests.shape[0])


def sharded_commit(cols: GF, rate: int, cap_size: int, mesh: Mesh):
    """Multi-rank commitment: the rank's (W/D, n) columns -> coset LDE (no
    collective) -> its row range of every column (all_to_all) -> leaf
    digests and its subtree -> the cap (all_gather).

    Returns (the rank's LDE columns, its row range's leaf digests, its
    subtree's levels, the whole cap)."""
    assert cap_size % mesh.size == 0, "cap must split across chips"
    lde = nt.coset_lde(cols, rate)
    tree = commit_rows_sharded(lde, cap_size, mesh)
    return lde, tree.levels[0], tree.levels, tree.cap


def shard_setup(setup, mesh: Mesh):
    """A PlonkishSetup with its sigma, const and table columns sharded by
    `shard_columns`' rule; the trees stay replicated."""
    return dataclasses.replace(
        setup,
        sigma_cols=shard_columns(setup.sigma_cols, mesh),
        const_cols=(shard_columns(setup.const_cols, mesh)
                    if setup.const_cols.shape[0] else setup.const_cols),
        table_cols=(shard_columns(setup.table_cols, mesh)
                    if setup.table_cols.shape[0] else setup.table_cols))


def gather_setup(setup, mesh: Mesh, ir):
    """Inverse of `shard_setup`."""
    table_w = sum(int(t.shape[1]) for t in setup.table_np)
    return dataclasses.replace(
        setup,
        sigma_cols=gather_columns(setup.sigma_cols, mesh, ir.num_witness),
        const_cols=gather_columns(setup.const_cols, mesh, ir.num_const),
        table_cols=gather_columns(setup.table_cols, mesh, table_w))


def prove_column_sharded(ir, setup, witness: GF, cfg, mesh: Mesh):
    """Multi-rank FULL prove, run in every rank: witness and setup columns
    sharded over the mesh, then `plonkish.prove(..., mesh=mesh)`, which
    shards the LDE-sized work (commitments, quotient cosets, DEEP, openings)
    and replicates the rest (`plonkish._prove_impl` says which is which).

    The proof is BIT-IDENTICAL to the one-rank prove of the same inputs, and
    the same in every rank: the transcript sees the same caps and
    evaluations."""
    from ..prover import plonkish as pk
    return pk.prove(ir, shard_setup(setup, mesh),
                    shard_columns(witness, mesh), cfg, device=mesh.device,
                    mesh=mesh)


# ---------------------------------------------------------------------------
# The sharded prover's collective steps (called by plonkish._prove_impl)
# ---------------------------------------------------------------------------

def commit_bundle(cols: Optional[GF], coeffs: Optional[GF], n_comm: int,
                  cap_size: int, mesh: Mesh):
    """(coefficients of every column, the rank's LDE columns, tree) of a
    bundle given whole by its columns or its coefficients. A bundle the
    mesh splits (columns, rows and cap) is transformed, hashed and committed
    in shards, its coefficients gathered; another is committed whole in
    every rank, as the JAX rule replicates it."""
    width = (cols if coeffs is None else coeffs).shape[0]
    if not (splits(width, mesh) and n_comm % mesh.size == 0
            and cap_size % mesh.size == 0):
        if coeffs is None:
            coeffs = nt.intt(cols)
        lde = nt.lde_from_coeffs(coeffs, n_comm)
        return coeffs, lde, mk.commit(lde.t(), cap_size)
    if coeffs is None:
        local = nt.intt(shard_columns(cols, mesh))
        coeffs = gather_columns(local, mesh, width)
    else:
        local = shard_columns(coeffs, mesh)
    lde = nt.lde_from_coeffs(local, n_comm)
    return coeffs, lde, commit_rows_sharded(lde, cap_size, mesh)


def share_cosets(acc, class_Ds, lde_eval: int, n: int, mesh: Mesh) -> None:
    """Fill `acc` ({D: [GF2 (n,) per coset of class D]}) in every rank: the
    values of coset c come from rank c % D, which evaluated it."""
    for c in range(lde_eval):
        src = c % mesh.size
        for D in class_Ds:
            step = lde_eval // D
            if c % step:
                continue
            if mesh.rank == src:
                v = acc[D][c // step]
                buf = torch.stack([v.c0, v.c1])
            else:
                buf = torch.empty((2, n), dtype=torch.int64,
                                  device=mesh.device)
            buf = broadcast(buf, src, mesh)
            acc[D][c // step] = GF2(buf[0], buf[1])


def sum_over_ranks(v: GF2, mesh: Mesh) -> GF2:
    """The field sum of every rank's `v` (exact, so in any order)."""
    parts = all_gather(torch.stack([v.c0, v.c1]), mesh)
    tot = parts[0]
    for p in parts[1:]:
        tot = gl.add(tot, p)
    return GF2(tot[0], tot[1])


def open_sharded(tree: ShardedTree, indices: np.ndarray, mesh: Mesh) -> GF:
    """Sibling paths (q, depth, 4) for `indices` of a sharded tree: each
    rank opens the indices in its row range, and the paths are gathered."""
    idx = np.asarray(indices, dtype=np.int64)
    rows = tree.levels[0].shape[0]
    mine = (idx >= tree.row0) & (idx < tree.row0 + rows)
    out = torch.zeros((len(idx), tree.sub.depth, mk.DIGEST_WIDTH),
                      dtype=torch.int64, device=mesh.device)
    if mine.any():
        pos = torch.from_numpy(np.nonzero(mine)[0]).to(mesh.device)
        out[pos] = mk.open_indices(tree.sub, idx[mine] - tree.row0)
    every = all_gather(out, mesh)
    owner = torch.from_numpy(idx // rows).to(mesh.device)
    return every[owner, torch.arange(len(idx), device=mesh.device)]

