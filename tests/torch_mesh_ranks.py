"""Rank-side functions of tests/test_torch_mesh.py: each runs inside every
rank of `parallel.mesh.run_on_mesh` (which imports it by name, so this
module imports the port only, never JAX) and returns host values gathered
to whole arrays."""

import json
import os

import numpy as np
import torch

from zkevm_harness_tpu_torch.circuits import flagship as fl
from zkevm_harness_tpu_torch.ops import goldilocks as gl
from zkevm_harness_tpu_torch.parallel import dist_ntt as dn
from zkevm_harness_tpu_torch.parallel import mesh as pm
from zkevm_harness_tpu_torch.prover import plonkish as pk
from zkevm_harness_tpu_torch.utils import serde


def _gather_domain(x, mesh):
    """Inverse of `shard_domain`: (C, N/D) slices -> (C, N)."""
    every = pm.all_gather(x, mesh)  # (D, C, N/D)
    return every.permute(1, 0, 2).reshape(x.shape[0], -1)


def prove_flagship(log_n, width, cfg_kw):
    """The column-sharded flagship proof (witness seed 0) as JSON."""
    mesh = pm.make_mesh()
    cfg = pk.PlonkishConfig(**cfg_kw)
    ir = fl.flagship_ir(log_n=log_n, width=width)
    setup = fl.flagship_setup(ir, cfg, device=mesh.device)
    witness = fl.flagship_witness(ir, seed=0, device=mesh.device)
    proof = pm.prove_column_sharded(ir, setup, witness, cfg, mesh)
    return json.loads(json.dumps(serde.proof_to_json(proof)))


def _transposes(mesh, n):
    """Each of `distributed_ntt`'s three exchanges, at its shapes for a
    (2, n) input, against the plain permutation: a global (C, A, B) array
    held as blocks of its axis 1 comes back as blocks of its axis 2."""
    n1, n2 = dn._split(n)
    d, r = mesh.size, mesh.rank
    ok = []
    for a, b in ((n1, n2), (n2, n1), (n1, n2)):
        glob = torch.arange(2 * a * b, dtype=torch.int64).reshape(2, a, b)
        local = glob[:, r * (a // d):(r + 1) * (a // d)]
        got = dn._all_to_all(local, 2, 1, mesh)
        want = glob[:, :, r * (b // d):(r + 1) * (b // d)]
        ok.append(torch.equal(got, want))
    return ok


def four_rank_cases(inputs, prove_args):
    """Every cheap case of the 4-rank mesh: the five helpers at
    tests/test_mesh.py's shapes, the three transposes, the sharding rule,
    the refused mesh, the log6 x 16 prove."""
    mesh = pm.make_mesh()
    dev = mesh.device
    out = {"size": mesh.size, "backend": mesh.backend}

    trace = gl.from_u64(inputs["lde"], dev)
    got = pm.sharded_coset_lde(pm.shard_columns(trace, mesh), 2, mesh)
    out["lde"] = gl.to_u64(pm.gather_columns(got, mesh, trace.shape[0]))

    evals = gl.from_u64(inputs["leaf_hash"], dev)
    dig = pm.sharded_leaf_hash(pm.shard_columns(evals, mesh), mesh)
    out["leaf_hash"] = gl.to_u64(pm.gather_columns(dig, mesh, evals.shape[1]))

    states = gl.from_u64(inputs["poseidon"], dev)
    got = pm.sharded_poseidon_throughput_step(
        pm.shard_columns(states, mesh), mesh)
    out["poseidon"] = gl.to_u64(pm.gather_columns(got, mesh, states.shape[0]))

    vals = gl.from_u64(inputs["ntt"], dev)
    got = dn.distributed_ntt(dn.shard_domain(vals, mesh), mesh)
    out["ntt"] = gl.to_u64(_gather_domain(got, mesh))

    cols = gl.from_u64(inputs["commit"], dev)
    lde, digests, levels, cap = pm.sharded_commit(
        pm.shard_columns(cols, mesh), 2, 8, mesh)
    per = 8 // mesh.size  # the rank's nodes of the cap
    out["commit"] = {
        "lde": gl.to_u64(pm.gather_columns(lde, mesh, cols.shape[0])),
        "digests": gl.to_u64(pm.gather_columns(digests, mesh,
                                          2 * cols.shape[1])),
        "cap": gl.to_u64(cap),
        "subtree_ends_at_its_cap_part": bool(
            torch.equal(levels[0], digests) and torch.equal(
                levels[-1], cap[mesh.rank * per:(mesh.rank + 1) * per]))}

    out["transposes"] = _transposes(mesh, 2048)
    out["shard_130"] = tuple(pm.shard_columns(
        gl.zeros((130, 4), dev), mesh).shape)
    try:
        dn.distributed_ntt(dn.shard_domain(gl.zeros((1, 8), dev), mesh), mesh)
        out["refused"] = None
    except AssertionError as e:
        out["refused"] = str(e)
    out["proof"] = prove_flagship(*prove_args)
    out["sent"] = pm.SENT_BYTES
    return out


def two_rank_cases(prove_args):
    """The 2-rank mesh: the sharding rule on 130 columns and the log6 x 16
    prove; what this rank sees of ZKEVM_LAUNCHES_FILE."""
    mesh = pm.make_mesh()
    return {"size": mesh.size, "backend": mesh.backend,
            "shard_130": tuple(pm.shard_columns(
                gl.zeros((130, 4), mesh.device), mesh).shape),
            "proof": prove_flagship(*prove_args),
            "launches_env": os.environ.get("ZKEVM_LAUNCHES_FILE")}


def fail_in_rank_one():
    mesh = pm.make_mesh()
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return np.zeros(1)
