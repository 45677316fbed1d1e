"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
`jax` nor the JAX package, and its default-device entry points raise on a
machine without a CUDA card instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_IMPORT_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    # start clean even if the interpreter's start-up imported jax
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "zkevm_harness_tpu"):
            del sys.modules[name]
    import zkevm_harness_tpu_torch as pkg
    names = ["zkevm_harness_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "zkevm_harness_tpu"))
    assert not bad, bad
    print("MODULES", " ".join(names))
""")


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    res = _run(_IMPORT_PROBE)
    assert res.returncode == 0, res.stderr[-2000:]
    names = res.stdout.split("MODULES", 1)[1].split()
    for expected in ("ops.goldilocks", "ops.cuda_kernels", "ops.poseidon2",
                     "ops.poseidon2_params", "ops.ntt", "ops.merkle",
                     "prover.transcript", "prover.fri", "prover.stark",
                     "prover.guard", "prover.plonkish", "circuits.flagship",
                     "utils.field_int", "utils.tracing", "utils.serde",
                     "convert", "golden", "vm.isa", "vm.state", "vm.encoding",
                     "vm.eravm", "vm.environment", "vm.interpreter",
                     "utils.keccak", "utils.native", "utils.secp256k1",
                     "witness.tracer", "witness.decommitter",
                     "witness.main_vm", "circuits.types",
                     "circuits.main_vm_circuit", "prover.layers",
                     "witness.encodings", "witness.storage_sort",
                     "witness.log_demux", "witness.queues", "witness.oracle",
                     "witness.ram_permutation", "witness.sorters",
                     "circuits.poseidon2_circuit",
                     "circuits.ram_permutation_circuit",
                     "circuits.narrow_region",
                     "circuits.events_sorter_circuit",
                     "circuits.storage_sorter_circuit",
                     "circuits.log_demux_circuit",
                     "witness.precompile_rounds",
                     "witness.precompile_circuits",
                     "witness.linear_hasher", "circuits.keccak_circuit",
                     "circuits.sha256_circuit",
                     "circuits.linear_hasher_circuit",
                     "circuits.decommitter_circuit",
                     "circuits.decommitts_sorter_circuit",
                     "prover.satisfy", "circuits.ffarith",
                     "circuits.ecrecover_circuit",
                     "circuits.storage_application_circuit",
                     "witness.ecrecover_witness", "witness.tree",
                     "witness.storage_application", "witness.recursion",
                     "witness.callstack_sim", "witness.vm_instance",
                     "circuits.builder", "circuits.verifier_circuit",
                     "circuits.leaf_circuit", "circuits.node_circuit",
                     "circuits.scheduler_circuit", "circuits.queue_circuit",
                     "witness.postprocessing", "witness.closed_form",
                     "witness.scheduler_witness", "utils.data_source",
                     "prover.scheduler", "harness", "utils.bn254",
                     "utils.bls12_381", "utils.kzg", "utils.plonk",
                     "utils.snark_wrapper", "prover.compression",
                     "witness.eip4844", "circuits.eip4844_circuit",
                     "full_chain", "utils.poseidon2_bn254",
                     "prover.hash_backend", "utils.plonk_builder",
                     "utils.snark_fri_verifier", "__main__",
                     "circuits.capacity", "circuits.ext_gadget",
                     "circuits.transcript_gadget", "circuits.merkle_circuit",
                     "circuits.fri_fold_circuit", "utils.ref_serde",
                     "utils.sequencer_api", "utils.test_artifacts",
                     "utils.kernel_bench", "parallel.mesh",
                     "parallel.dist_ntt"):
        assert "zkevm_harness_tpu_torch." + expected in names


def test_no_source_line_imports_jax():
    pkg = os.path.join(REPO, "zkevm_harness_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, fnames in os.walk(pkg):
        files += [os.path.join(root, f) for f in fnames if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            for line in f:
                stripped = line.strip()
                if stripped.startswith(("import ", "from ")):
                    head = stripped.split()[1].split(".")[0]
                    assert head not in ("jax", "jaxlib", "zkevm_harness_tpu"), \
                        (path, stripped)


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch.circuits import flagship as fl
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.prover.transcript import Transcript

    cfg = pk.PlonkishConfig(rate=2, cap_size=4, num_queries=8,
                            final_fri_size=8)
    ir = fl.flagship_ir(log_n=6, width=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fl.flagship_witness(ir, seed=42)
    with pytest.raises(RuntimeError, match="CUDA"):
        fl.flagship_setup(ir, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcript()
    setup = fl.flagship_setup(ir, cfg, device="cpu")
    witness = fl.flagship_witness(ir, seed=42, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pk.prove(ir, setup, witness, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pk.verify(ir, setup.vk(), None, cfg)


def test_cli_without_device_fails_without_cuda(tmp_path):
    """`python -m zkevm_harness_tpu_torch prove` with no --device on a
    machine without a card exits non-zero and writes no proof."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "proof.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "zkevm_harness_tpu_torch",
                          "prove", "--log-n", "6", "--width", "8",
                          "--out", str(out)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not out.exists()


def test_stark_and_gadget_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import ext_gadget as eg
    from zkevm_harness_tpu_torch.circuits import fri_fold_circuit as fc
    from zkevm_harness_tpu_torch.circuits import merkle_circuit as mc
    from zkevm_harness_tpu_torch.circuits import transcript_gadget as tg
    from zkevm_harness_tpu_torch.ops import goldilocks as gl
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.prover import stark as st
    from zkevm_harness_tpu_torch.utils import kernel_bench, sequencer_api

    air = st.Air(3, 6, 2, 3, golden.fib_mul_transitions,
                 golden.FIB_MUL_BOUNDARY)
    trace = gl.from_int(np.array(golden.fib_mul_trace(6), dtype=object),
                        "cpu")
    cfg = pk.PlonkishConfig(**golden.GADGET_CONFIG)
    ir = eg.ext_chain_ir(4)
    for call in (lambda: st.prove(air, trace),
                 lambda: st.verify(air, None),
                 lambda: st._zh_over_last_inv(64, 4, 7),
                 lambda: eg.ext_chain_setup(ir, cfg),
                 lambda: eg.ext_chain_witness(ir, (1, 2)),
                 lambda: eg.inverse_witness(eg.inverse_ir(5), [3]),
                 lambda: fc.fold_witness(fc.fold_ir(5), []),
                 lambda: tg.transcript_witness(tg.transcript_ir(6, [0]), []),
                 lambda: tg.expected_challenges([[0] * 8], [0]),
                 lambda: mc.merkle_setup(mc.merkle_ir(6), cfg),
                 lambda: sequencer_api.events_queue_commitment([]),
                 lambda: kernel_bench.bench_kernels()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_main_vm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import main_vm_circuit as mvc
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.vm import isa
    from zkevm_harness_tpu_torch.witness import main_vm as wmv

    geo = mvc.VmGeometry(**golden.MAIN_VM_GEOMETRY)
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    ir = mvc.main_vm_ir(geo)
    tracer = golden.trace_program([isa.Nop(), isa.Ret()], 10)
    art = wmv.compute_main_vm_artifacts(tracer, geo, capacity=8, device="cpu")
    inst = art.instances[0]
    for call in (lambda: wmv.draw_vm_challenges(inst.rows, geo),
                 lambda: wmv.compute_main_vm_artifacts(tracer, geo,
                                                       capacity=8),
                 lambda: mvc.main_vm_setup(ir, geo, cfg),
                 lambda: mvc.main_vm_witness(ir, geo, inst),
                 lambda: ly.main_vm_setup_data(8),
                 lambda: ly.prove_main_vm_instance(inst, 8),
                 lambda: ly.verify_main_vm_instance(inst, 8, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_memory_and_log_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import events_sorter_circuit as ec
    from zkevm_harness_tpu_torch.circuits import log_demux_circuit as dc
    from zkevm_harness_tpu_torch.circuits import narrow_region as nrr
    from zkevm_harness_tpu_torch.circuits import ram_permutation_circuit as rc
    from zkevm_harness_tpu_torch.circuits import storage_sorter_circuit as sc
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.witness import log_demux, oracle, queues
    from zkevm_harness_tpu_torch.witness import ram_permutation as wram
    from zkevm_harness_tpu_torch.witness import sorters

    tracer = golden.trace_main_vm_block()
    mem = [q for _, q in tracer.memory_queries]
    log = [q for _, q in tracer.final_log_queue()]
    events = [q for _, q in
              oracle.demux_log_queue(tracer.final_log_queue())["events"]]
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    rgeo, egeo = rc.RamGeometry(8, 1), ec.EventsGeometry(8, 2)
    sgeo, dgeo = sc.StorageGeometry(8, 11), dc.DemuxGeometry(8, 3)
    art = wram.compute_ram_circuit_snapshots(mem, 8, device="cpu")
    rinst = rc.instance_inputs(art.instances[0], art.challenges)
    for call in (lambda: queues.QueueSimulator(),
                 lambda: queues.FullWidthQueueSimulator(),
                 lambda: wram.compute_ram_circuit_snapshots(mem, 8),
                 lambda: sorters.compute_events_circuit_artifacts(events, 3),
                 lambda: sorters.compute_storage_circuit_artifacts([], 4),
                 lambda: log_demux.compute_log_demux_artifacts(log, 6),
                 lambda: rc.ram_setup(rc.ram_ir(8, 1), rgeo, cfg),
                 lambda: rc.ram_witness(rc.ram_ir(8, 1), rgeo, rinst),
                 lambda: ec.events_setup(ec.events_ir(8, 2), egeo, cfg),
                 lambda: sc.storage_setup(sc.storage_ir(8, 11), sgeo, cfg),
                 lambda: dc.demux_setup(dc.demux_ir(8, 3), dgeo, cfg),
                 lambda: nrr.narrow_region_witness(
                     egeo.region, np.zeros((1, 20), np.uint64), [1],
                     (0, 0, 0, 0), rc.block_const_rows_u64()),
                 lambda: ly.ram_setup_data(8), lambda: ly.events_setup_data(3),
                 lambda: ly.storage_setup_data(21),
                 lambda: ly.demux_setup_data(6),
                 lambda: ly.prove_ram_instance(art.instances[0],
                                               art.challenges, 8),
                 lambda: ly.verify_ram_instance(art.instances[0],
                                                art.challenges, 8, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_hash_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import decommitter_circuit as dc
    from zkevm_harness_tpu_torch.circuits import \
        decommitts_sorter_circuit as ds
    from zkevm_harness_tpu_torch.circuits import keccak_circuit as kc
    from zkevm_harness_tpu_torch.circuits import linear_hasher_circuit as lh
    from zkevm_harness_tpu_torch.circuits import sha256_circuit as sc
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.witness import decommitter, linear_hasher
    from zkevm_harness_tpu_torch.witness import precompile_circuits as pc
    from zkevm_harness_tpu_torch.witness import sorters

    tracer = golden.trace_hash_block(**golden.HASH_GOLDEN)
    calls = [d for (_, q, d, _r) in tracer.precompile_calls
             if q.address == golden.KECCAK_ADDRESS]
    queries = [q for _, q in tracer.decommittment_queries]
    fresh = [q for q in queries if q.is_fresh]
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    kart = pc.compute_keccak_circuit_artifacts(calls, 4, device="cpu")
    kinst = kart.instances[0]
    kpay = kc.instance_inputs(kinst.invocations, kart.challenges,
                              kart.gammas)
    dart = decommitter.compute_code_decommitter_artifacts(
        fresh, tracer.decommitted_bytecodes, device="cpu")
    sart = sorters.compute_decommitts_circuit_artifacts(queries, 8,
                                                        device="cpu")
    for call in (lambda: pc.compute_keccak_circuit_artifacts(calls, 4),
                 lambda: pc.compute_sha256_circuit_artifacts(calls, 3),
                 lambda: linear_hasher.compute_hasher_circuit_artifacts(
                     [], 4),
                 lambda: decommitter.compute_code_decommitter_artifacts(
                     fresh, tracer.decommitted_bytecodes),
                 lambda: sorters.compute_decommitts_circuit_artifacts(
                     queries, 8),
                 lambda: kc.draw_keccak_challenges(kinst.invocations),
                 lambda: lh.instance_inputs(b"l1"),
                 lambda: dc.instance_inputs([1, 2, 3]),
                 lambda: kc.keccak_setup(kc.keccak_ir(7), kc.KeccakGeometry(7),
                                         cfg),
                 lambda: kc.keccak_witness(kc.keccak_ir(7),
                                           kc.KeccakGeometry(7), kpay),
                 lambda: sc.sha256_setup(sc.sha256_ir(8),
                                         sc.Sha256Geometry(8), cfg),
                 lambda: lh.hasher_setup(lh.hasher_ir(7),
                                         lh.HasherGeometry(7), cfg),
                 lambda: dc.decommitter_witness(
                     dc.decommitter_ir(8), dc.DecommitterGeometry(8),
                     dart.instances[0]),
                 lambda: ds.decommitts_setup(ds.decommitts_ir(8, 1),
                                             ds.DecommittsGeometry(8, 1),
                                             cfg),
                 lambda: ly.keccak_setup_data(4),
                 lambda: ly.sha256_setup_data(3),
                 lambda: ly.hasher_setup_data(4),
                 lambda: ly.code_decommitter_setup_data(3),
                 lambda: ly.decommitts_setup_data(8),
                 lambda: ly.prove_keccak_instance(
                     kinst, (kart.challenges, kart.gammas), 4),
                 lambda: ly.verify_sha256_instance(
                     kinst, (kart.challenges, kart.gammas), 3, None),
                 lambda: ly.prove_hasher_instance(None, 4),
                 lambda: ly.prove_code_decommitter_instance(
                     dart.instances[0], 3),
                 lambda: ly.verify_code_decommitter_instance(
                     dart.instances[0], 3, None),
                 lambda: ly.prove_decommitts_instance(
                     sart.instances[0], sart.challenges, 8),
                 lambda: ly.verify_decommitts_instance(
                     sart.instances[0], sart.challenges, 8, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_block_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import ecrecover_circuit as ecc
    from zkevm_harness_tpu_torch.circuits import ffarith as ff
    from zkevm_harness_tpu_torch.circuits import \
        storage_application_circuit as sac
    from zkevm_harness_tpu_torch.circuits.types import testing_geometry
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.witness import callstack_sim, oracle
    from zkevm_harness_tpu_torch.witness import recursion
    from zkevm_harness_tpu_torch.witness.ecrecover_witness import \
        ecrecover_decompose

    tracer, pre = golden.trace_whole_block(**golden.WHOLE_GOLDEN)
    cfg = pk.PlonkishConfig(**golden.MAIN_VM_CONFIG)
    eprog = ecc.build_ecrecover_program(
        ecc.CurveParams(**golden.ecrecover_toy_curve()))
    ir = ff.layout_ir(eprog.layout)
    h, r, s, q, ry = golden.ecrecover_toy_signature()
    geo = sac.PathGeometry(golden.STORAGE_APP_DEPTH)
    path = sac.PathInstanceInputs(golden.STORAGE_APP_LEAF,
                                  list(golden.STORAGE_APP_PATH_BITS),
                                  list(golden.STORAGE_APP_SIBLINGS))
    inv = ecrecover_decompose(golden.ecrecover_inputs(1), 7)[0]
    for call in (lambda: oracle.create_artifacts_from_tracer(
                     tracer, testing_geometry(), initial_storage=pre),
                 lambda: ff.ff_setup(eprog.layout, cfg),
                 lambda: ff.ff_witness(eprog.layout, ir, {}),
                 lambda: ecc.ecrecover_witness(eprog, ir, h, r, s, q, ry),
                 lambda: sac.path_setup(sac.path_ir(geo), geo, cfg),
                 lambda: sac.path_witness(sac.path_ir(geo), geo, path),
                 lambda: callstack_sim.simulate_callstack(tracer),
                 lambda: recursion.RecursionQueueSimulator(),
                 lambda: recursion.commit_vk([1, 2, 3]),
                 lambda: ly.ecrecover_setup_data(),
                 lambda: ly.prove_ecrecover_invocation(inv.invocations[0]),
                 lambda: ly.verify_ecrecover_invocation(inv.invocations[0],
                                                        None),
                 lambda: ly.storage_application_setup_data(depth=4),
                 lambda: ly.prove_storage_application_path(path),
                 lambda: ly.verify_storage_application_path(path, None),
                 lambda: ly.prove_storage_application_query((path, path)),
                 lambda: ly.base_setup_for_type(10, testing_geometry()),
                 lambda: ly.prove_base_instance(10, path, None, 2),
                 lambda: ly.verify_base_instance(10, path, None, 2, None),
                 lambda: ly.create_base_layer_setup_data(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_wrappers_refuse_a_wrong_device_or_type():
    from zkevm_harness_tpu_torch.ops import cuda_kernels as ck
    a = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        ck.gl_mul(a, a.to(torch.int32))
    with pytest.raises(TypeError):
        ck.gl_pow7(a.to(torch.float32))
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ck.gl_mul(meta, meta)
    with pytest.raises(ValueError):
        ck.poseidon2_permute(torch.zeros((2, 12), dtype=torch.int64,
                                         device="meta"))
    with pytest.raises(ValueError):
        ck.gl_add(a, meta)


def test_recursion_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import golden, harness
    from zkevm_harness_tpu_torch.circuits import builder as bd
    from zkevm_harness_tpu_torch.circuits import leaf_circuit as lc
    from zkevm_harness_tpu_torch.circuits import queue_circuit as qc
    from zkevm_harness_tpu_torch.circuits import scheduler_circuit as sc
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.vm import isa
    from zkevm_harness_tpu_torch.witness import postprocessing as pp

    b = bd.CircuitBuilder()
    x = b.input()
    b.mark_public(b.mul(x, x))
    built = b.finalize()
    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    for call in (lambda: b.fill_witness({x: 3}),
                 lambda: b.unsatisfied_gates(b.eval_values({x: 3})),
                 lambda: built.setup(cfg),
                 lambda: qc.queue_setup(qc.queue_ir(6), cfg),
                 lambda: qc.queue_witness(qc.queue_ir(6), []),
                 lambda: lc.advance_queue_head((0,) * 12, 8, []),
                 lambda: sc.scheduler_multi_public_inputs(None, [], [], 1),
                 lambda: pp.CircuitMaker(8),
                 lambda: ly.create_recursive_layer_setup_data(1),
                 lambda: harness.run_block(golden.tower_block(isa))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_wrap_entry_points_raise_without_cuda():
    """The blob branch, the compression layers (the for-wrapper mode and
    its hash backend too) and the full chain raise on a machine without a
    CUDA card; an unknown SNARK tier raises whatever the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from zkevm_harness_tpu_torch import full_chain as fc
    from zkevm_harness_tpu_torch import golden
    from zkevm_harness_tpu_torch.circuits import eip4844_circuit as e4
    from zkevm_harness_tpu_torch.circuits import queue_circuit as qc
    from zkevm_harness_tpu_torch.prover import hash_backend as hb
    from zkevm_harness_tpu_torch.prover import layers as ly
    from zkevm_harness_tpu_torch.prover import plonkish as pk
    from zkevm_harness_tpu_torch.vm import isa

    cfg = pk.PlonkishConfig(**golden.TOWER_GOLDEN_CONFIG)
    ir = qc.queue_ir(5)
    for call in (lambda: ly.create_eip4844_setup_data(16),
                 lambda: ly.prove_eip4844([1] * 16, 3, n_elements=16),
                 lambda: ly.verify_eip4844([1] * 16, 3, None, n_elements=16),
                 lambda: e4.draw_blob_challenges([1, 2]),
                 lambda: e4.instance_inputs([1, 2], 3),
                 lambda: ly.create_compression_layer_setup_data(1, ir, cfg),
                 lambda: ly.CompressionChain(ir, cfg, [0] * 4),
                 lambda: ly.CompressionChain(ir, cfg, [0] * 4,
                                             wrapper_mode=1),
                 lambda: ly.create_compression_for_wrapper_setup_data(
                     1, ir, cfg),
                 lambda: ly.verify_compression_for_wrapper_proof(
                     1, ir, cfg, None),
                 lambda: hb.Bn254Backend(),
                 lambda: hb.Bn254Transcript(),
                 lambda: fc.prove_block_full_chain(golden.tower_block(isa),
                                                   chain_types=(8,)),
                 lambda: fc.prove_block_full_chain(
                     golden.tower_block(isa), chain_types=(8,),
                     for_wrapper=True, snark_mode="binding")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    chain = ly.CompressionChain(ir, cfg, [0] * 4, wrapper_mode=1,
                                device="cpu")
    assert chain.device.type == "cpu"
    with pytest.raises(ValueError, match="SNARK mode"):
        fc.prove_block_full_chain(golden.tower_block(isa), chain_types=(8,),
                                  snark_mode="plonk", device="cpu")


def _package_digest(root):
    """SHA-256 over the paths and bytes of a package's source and data
    files (caches aside)."""
    import hashlib
    h = hashlib.sha256()
    for dirpath, dirs, files in sorted(os.walk(root)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if name.endswith((".py", ".json")):
                path = os.path.join(dirpath, name)
                h.update(os.path.relpath(path, root).encode() + b"\0")
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


# the JAX package as the port found it: its source and data files, which
# the port reads as a reference and never edits
JAX_PACKAGE_SHA256 = (
    "78e29ce68f0b5cab34fcf395cb61398297a41b89d229e0b618dba05e69d86c6c")


def test_jax_package_is_unchanged():
    assert _package_digest(os.path.join(REPO, "zkevm_harness_tpu")) == \
        JAX_PACKAGE_SHA256


def test_bn254_params_are_read_never_written(tmp_path):
    """The port reads its own copy of the Poseidon2-BN254 table: with that
    file gone it raises, and it writes the table neither into its own
    package nor into the JAX package's."""
    import shutil
    jax_json = os.path.join(REPO, "zkevm_harness_tpu", "params",
                            "poseidon2_bn254.json")
    with open(jax_json, "rb") as f:
        jax_bytes = f.read()
    shutil.copytree(os.path.join(REPO, "zkevm_harness_tpu_torch"),
                    tmp_path / "zkevm_harness_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    copy_json = tmp_path / "zkevm_harness_tpu_torch" / "params" / \
        "poseidon2_bn254.json"
    os.remove(copy_json)
    probe = textwrap.dedent("""
        from zkevm_harness_tpu_torch.utils import poseidon2_bn254 as p2b
        try:
            p2b.permute([1, 2, 3])
        except FileNotFoundError:
            print("RAISED")
    """)
    res = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=120)
    assert "RAISED" in res.stdout, res.stderr[-2000:]
    assert not copy_json.exists()
    with open(jax_json, "rb") as f:
        assert f.read() == jax_bytes
