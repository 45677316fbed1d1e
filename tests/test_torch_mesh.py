"""Port vs JAX package: the column-sharded pipeline (`parallel/mesh.py`) and
the distributed NTT (`parallel/dist_ntt.py`), bit for bit (tolerance 0,
field integers).

The port's functions run in gloo ranks on the CPU through `run_on_mesh`;
the cheap cases of one rank count share one spawn (a module-scoped fixture
returns every case's result, computed in tests/torch_mesh_ranks.py). The JAX
functions run on the 8-device virtual CPU mesh of tests/conftest.py, at
tests/test_mesh.py's shapes and inputs; the JAX side of the proofs is the
committed output of tools/gen_mesh_golden.py."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as ranks
from zkevm_harness_tpu.ops import goldilocks as jgl
from zkevm_harness_tpu.parallel import dist_ntt as jdn
from zkevm_harness_tpu.parallel import mesh as jpm
from zkevm_harness_tpu_torch.circuits import flagship as fl
from zkevm_harness_tpu_torch.parallel import mesh as pm
from zkevm_harness_tpu_torch.prover import plonkish as pk

ART = os.path.join(os.path.dirname(__file__), "..", "test_artifacts")
LOG6 = (6, 16, dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8))
LOG9 = (9, 64, dict(rate=2, cap_size=8, num_queries=8, final_fri_size=16))


def _golden(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _inputs():
    """tests/test_mesh.py's inputs: each test there draws from a fresh
    default_rng(0)."""
    def draw(shape):
        return np.random.default_rng(0).integers(0, 2**63, size=shape,
                                                 dtype=np.uint64)
    return {"lde": draw((16, 64)), "leaf_hash": draw((8, 64)),
            "poseidon": draw((16, 12)), "ntt": draw((3, 1024)),
            "commit": draw((16, 64))}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def four(inputs):
    res = pm.run_on_mesh(ranks.four_rank_cases, 4, inputs, LOG6,
                         device="cpu")
    assert [r["size"] for r in res] == [4] * 4
    assert {r["backend"] for r in res} == {"gloo"}
    # every rank returns the same whole arrays and the same proof
    for r in res[1:]:
        assert r["proof"] == res[0]["proof"]
        for k in ("lde", "leaf_hash", "poseidon", "ntt"):
            assert np.array_equal(r[k], res[0][k])
    return res


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("launches") / "counts.json")
    outer = os.environ.get("ZKEVM_LAUNCHES_FILE")
    os.environ["ZKEVM_LAUNCHES_FILE"] = base
    try:
        res = pm.run_on_mesh(ranks.two_rank_cases, 2, LOG6, device="cpu",
                             same=lambda r: r["proof"])
    finally:
        if outer is None:
            del os.environ["ZKEVM_LAUNCHES_FILE"]
        else:
            os.environ["ZKEVM_LAUNCHES_FILE"] = outer
    return res, base


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return jpm.make_mesh(8)


def test_sharded_lde_matches_single(four, inputs, jmesh):
    x = jgl.from_u64(inputs["lde"])
    want = jpm.sharded_coset_lde(jpm.shard_columns(x, jmesh), 2, jmesh)
    assert np.array_equal(four[0]["lde"], jgl.to_u64(want))


def test_sharded_leaf_hash_matches(four, inputs, jmesh):
    x = jgl.from_u64(inputs["leaf_hash"])
    want = jpm.sharded_leaf_hash(jpm.shard_columns(x, jmesh), jmesh)
    assert np.array_equal(four[0]["leaf_hash"], jgl.to_u64(want))


def test_sharded_poseidon_matches(four, inputs, jmesh):
    x = jgl.from_u64(inputs["poseidon"])
    want = jpm.sharded_poseidon_throughput_step(jpm.shard_columns(x, jmesh),
                                                jmesh)
    assert np.array_equal(four[0]["poseidon"], jgl.to_u64(want))


def test_distributed_ntt_matches_single(four, inputs):
    m = jdn.Mesh(np.array(jax.devices()[:8]), ("x",))
    x = jgl.from_u64(inputs["ntt"])
    want = jdn.distributed_ntt(jdn.shard_domain(x, m), m)
    assert np.array_equal(four[0]["ntt"], jgl.to_u64(want))


def test_sharded_commit_matches_single(four, inputs, jmesh):
    x = jgl.from_u64(inputs["commit"])
    lde, digests, cap = jpm.sharded_commit(jpm.shard_columns(x, jmesh), 2, 8,
                                           jmesh)
    got = four[0]["commit"]
    assert np.array_equal(got["lde"], jgl.to_u64(lde))
    assert np.array_equal(got["digests"], jgl.to_u64(digests))
    assert np.array_equal(got["cap"], jgl.to_u64(cap))
    assert all(r["commit"]["subtree_ends_at_its_cap_part"] for r in four)


def test_multichip_full_prove_bit_identical(four):
    """Over 4 ranks, every rank's proof equals the JAX package's
    column-sharded proof on its 8-device mesh."""
    assert four[0]["proof"] == _golden("mesh_log6_w16_proof.json")


def test_prove_column_sharded_over_two_ranks(two):
    res, _ = two
    assert res[0]["proof"] == _golden("mesh_log6_w16_proof.json")


def test_prove_column_sharded_counts_collective_bytes(four):
    sent = four[0]["sent"]
    assert sent["stage1_commit"]["all_to_all"] > 0
    assert sent["quotient_cosets"]["broadcast"] > 0
    assert sent["openings"]["all_gather"] > 0


def test_shard_columns_replicates_what_the_mesh_does_not_divide(four, two):
    assert four[0]["shard_130"] == (130, 4)  # 130 % 4: replicated
    assert [r["shard_130"] for r in two[0]] == [(65, 4), (65, 4)]


def test_all_to_all_matches_the_plain_permutation(four):
    # the three exchanges of a (2, 2^11) distributed NTT in every rank
    assert all(r["transposes"] == [True, True, True] for r in four)


def test_distributed_ntt_refuses_a_mesh_that_does_not_divide_n1(four):
    # n = 8 splits 2 x 4: 4 ranks do not divide N1 = 2
    assert all(r["refused"] == "device count must divide both factors"
               for r in four)


def test_each_rank_writes_its_own_launch_counts(two):
    res, base = two
    assert [r["launches_env"] for r in res] == [None, None]
    assert not os.path.exists(base)
    for r in range(2):
        with open(f"{base}.rank{r}") as f:
            assert "gl_mul" in json.load(f)


def test_a_failing_rank_fails_the_call():
    with pytest.raises(Exception, match="rank one fails"):
        pm.run_on_mesh(ranks.fail_in_rank_one, 2, device="cpu", timeout_s=60)


def test_mesh_with_a_hash_backend_is_refused():
    cfg = pk.PlonkishConfig(**LOG6[2])
    ir = fl.flagship_ir(log_n=6, width=8)
    setup = fl.flagship_setup(ir, cfg, device="cpu")
    witness = fl.flagship_witness(ir, seed=42, device="cpu")
    mesh = pm.Mesh(size=1, rank=0, device=torch.device("cpu"),
                   backend="gloo")
    with pytest.raises(NotImplementedError):
        pk.prove(ir, setup, witness, cfg, backend=object(), device="cpu",
                 mesh=mesh)


@pytest.mark.slow
def test_dryrun_shape_golden():
    """The multi-chip dry run's prove (2^9 x 64, cap 8, final 16) over 4
    ranks equals the JAX package's on its 8-device mesh."""
    res = pm.run_on_mesh(ranks.prove_flagship, 4, *LOG9, device="cpu",
                         same=lambda p: p)
    assert res[0] == _golden("mesh_log9_w64_proof.json")
