"""Full-chain block proving: block -> base -> leaf -> node -> scheduler ->
compression -> SNARK wrapper, every link a REAL proof of the previous link.

The basic_test analogue (reference:
src/tests/complex_tests/mod.rs:268-1142 — base loop :316-407, leaf
:529-647, node :797-945, scheduler :1081-1142, then wrap_proof,
src/proof_wrapper_utils/mod.rs:99-154). No mocks, no metadata tasks:

  1. the block executes and every selected base type's decomposer instances
     are proven with their real gate sets (verify-after-prove);
  2. per type, a LEAF circuit verifies that type's base proofs IN-CIRCUIT
     (circuits/leaf_circuit.py: shared VK transcript replay + recursion
     queue absorption) and is itself proven;
  3. a NODE circuit verifies the leaf proof in-circuit and re-exposes the
     spliced queue interval (circuits/node_circuit.py);
  4. the SCHEDULER circuit verifies every type's node proof in-circuit —
     heterogeneous shapes, one verifier slot per type — checks each queue
     was consumed from EMPTY, and emits the block commitment
     (circuits/scheduler_circuit.synthesize_scheduler_multi);
  5. compression mode 1..k verifies the scheduler proof in-circuit
     (prover/layers.CompressionChain), and the BN254 PLONK wrapper packs
     the scheduler commitment into the single L1 public input.

Scale knobs (the reference's testing-geometry analogue,
run_manually.rs:184-200): `chain_types` selects which base types feed the
recursion tower (production: all 13; CPU tests: narrow types — wide
circuits like keccak/storage-application verify in-circuit only at TPU
scale), and `base_cfg`/`recursion_cfg`/`compression_cfg` set the FRI
parameters (production: layer proof configs of circuits/types.py).

Cross-bindings asserted along the way:
  - every leaf tail equals the harness recursion queue tail for that type
    (the DAG's queue of REAL closed-form-input digests is what the leaf
    circuit recomputes in-circuit from the child proofs);
  - tampering any base proof makes the leaf circuit unsatisfiable
    (tests/test_full_chain.py).

Counterpart of the JAX package's `full_chain.py` over the port's
`harness.run_block`: Goldilocks-hashed compression modes, the BN254-hashed
final mode (`for_wrapper=True`, its trees on the device's Poseidon2-BN254
kernel) and the three SNARK tiers ("pi"; "binding" and "full" over the
for-wrapper proof). Every proof runs on `device` (`None`:
the CUDA card, raising where there is none); `FullChainResult.stats` holds,
per proof of the blob branch, the compression chain and the wrapper, its
shape and the seconds of each step (with its peak device memory and kernel
launches on a CUDA device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import harness
from .circuits.types import GeometryConfig, testing_geometry
from .ops import goldilocks as gl
from .prover import compression as cmp
from .prover import layers as ly
from .prover import plonkish as pk
from .utils import snark_wrapper as sw
from .utils import tracing
from .utils.data_source import InMemoryDataSource

P = gl.P


@dataclasses.dataclass
class StageProof:
    """One recursion-tower stage: the proof plus everything needed to
    verify it in-circuit one level up."""
    proof: pk.PlonkishProof
    vk: list
    ir: pk.PlonkishIR
    cfg: pk.PlonkishConfig


@dataclasses.dataclass
class FullChainResult:
    block: harness.BlockProvingResult
    chain_types: Tuple[int, ...]
    base_proofs: Dict[int, List[pk.PlonkishProof]]
    leaves: Dict[int, StageProof]          # last chunk's proof per type
    nodes: Dict[int, StageProof]
    scheduler: StageProof
    scheduler_pi: List[int]  # 4-lane block commitment
    final: Optional[dict]    # compression output + snark_public_input
    snark: Optional[dict]    # BN254 PLONK wrapper proof/vk
    eip4844: List[dict] = dataclasses.field(default_factory=list)
    stats: Dict[str, Dict] = dataclasses.field(default_factory=dict)


def prove_block_full_chain(code, chain_types: Sequence[int],
                           geometry: Optional[GeometryConfig] = None,
                           base_cfg: Optional[pk.PlonkishConfig] = None,
                           recursion_cfg: Optional[pk.PlonkishConfig] = None,
                           compression_cfg: Optional[pk.PlonkishConfig] = None,
                           compression_layers: int = 1,
                           contracts=None, cycle_limit: int = 10_000,
                           block_number: int = 1,
                           wrap: bool = True,
                           for_wrapper: bool = False,
                           leaf_arity: Optional[int] = None,
                           snark_mode: str = "pi",
                           blobs: Optional[Sequence[bytes]] = None,
                           blob_kzg_settings=None,
                           blob_cfg: Optional[pk.PlonkishConfig] = None,
                           progress=None, source=None,
                           type_workers: int = 0,
                           device=None) -> FullChainResult:
    """Prove one block through every layer. Returns the assembled tower;
    raises if any link fails verification. `source` (e.g. a
    LocalFileDataSource) receives every real proof in the reference's
    get/set naming scheme (complex_tests/mod.rs:588-592 resume protocol).

    `blob_cfg` is the config of the blob proofs (default `base_cfg`, as
    the JAX package proves them). A small testing blob under a large final
    FRI size needs its own: 16 elements are a 2^8-row circuit, which a
    final FRI size of 512 at rate 2 does not fold, and the setup refuses
    it. The config used is in `stats["eip4844_<b>"]["config"]` and in each
    blob record. `compression_cfg`, `wrap` and `progress` are the knobs of
    the JAX package's CLI; `leaf_arity` splits a type's base proofs into
    leaf chunks as `harness.run_block` does, and `type_workers` (the
    port's own) goes to it as it is."""
    if snark_mode not in ("pi", "binding", "full"):
        raise ValueError(f"unknown SNARK mode {snark_mode!r}")
    device = gl.resolve_device(device)
    stats: Dict[str, Dict] = {}
    geometry = geometry or testing_geometry()
    chain_types = tuple(sorted(int(t) for t in chain_types))
    recursion_cfg = recursion_cfg or pk.PlonkishConfig(
        rate=2, cap_size=4, num_queries=2, final_fri_size=8)

    def say(msg):
        if progress:
            progress(msg)

    # -- 0. EIP-4844 blob branch (complex_tests/mod.rs:995-1075) --------------
    # Per blob: the full witness chain (KZG commitment, versioned hash,
    # evaluation point, Horner opening) plus a REAL fold-circuit proof. The
    # fold proofs are block-independent, so they are proven FIRST and fed
    # into the scheduler task as in-circuit verifier slots (the reference
    # passes eip4844_proofs + VK into the scheduler witness and the
    # scheduler circuit verifies them — complex_tests/mod.rs:993-1007);
    # the blob OUTPUT COMMITMENTS additionally feed the scheduler's aux
    # values, so the block commitment binds both the host-side hashes and
    # the proven openings.
    source = source or InMemoryDataSource()
    eip4844_records: List[dict] = []
    eip4844_slots: List[dict] = []
    if blobs:
        from .utils import kzg as kzg_mod
        from .utils.native import keccak256
        from .witness import eip4844 as w4844
        settings = blob_kzg_settings or kzg_mod.KzgSettings.testing(16)
        n_el = settings.domain_size
        for blob in blobs:
            chunks, linear_hash, versioned_hash, output_hash = \
                w4844.generate_eip4844_witness(blob, settings)
            x = int.from_bytes(keccak256(linear_hash + versioned_hash)[16:],
                               "big") % kzg_mod.R
            elements = [int.from_bytes(c, "little") for c in chunks]
            eip4844_records.append(dict(
                elements=elements, x=x, linear_hash=linear_hash,
                versioned_hash=versioned_hash, output_hash=output_hash,
                n_elements=n_el))
    blob_outputs = tuple(r["output_hash"] for r in eip4844_records)

    with ly.engine_override(blob_cfg or base_cfg):
        for bi, rec in enumerate(eip4844_records):
            watch = tracing.Stopwatch(device)
            sd, _prog = ly.create_eip4844_setup_data(
                rec["n_elements"], limb_bits=8, device=device)
            watch.lap("setup")
            proof4844 = ly.prove_eip4844(rec["elements"], rec["x"],
                                         n_elements=rec["n_elements"],
                                         limb_bits=8, source=source,
                                         device=device)
            watch.lap("prove")
            assert ly.verify_eip4844(rec["elements"], rec["x"], proof4844,
                                     n_elements=rec["n_elements"],
                                     limb_bits=8, device=device), \
                f"eip4844 proof for blob {bi} failed verification"
            watch.lap("verify")
            stats[f"eip4844_{bi}"] = watch.done(
                log_n=sd.ir.log_n, width=sd.ir.num_witness,
                public_inputs=len(sd.ir.public_input_cells),
                config=dataclasses.asdict(sd.config))
            rec.update(proof=proof4844, vk=sd.vk, cfg=sd.config)
            eip4844_slots.append({"ir": sd.ir, "cfg": sd.config,
                                  "vk": sd.vk, "proof": proof4844})
            source.set({"kind": "eip4844", "real": True, "proof": proof4844,
                        "output_hash": rec["output_hash"]},
                       "eip4844_proof", bi)
            say(f"eip4844 blob {bi} proven (verified in-circuit by the "
                "scheduler below)")

    # -- 1.-4. base + leaf + node + scheduler via the DAG --------------------
    # The WHOLE tower runs through run_dag (run_block tower=True): real
    # leaf/node/scheduler tasks with store-guarded skip-if-present resume
    # and parallel-wave dispatch — the pod-level orchestration the
    # reference's basic_test protocol implies (complex_tests/mod.rs:323-331).
    with ly.engine_override(base_cfg):
        blk = harness.run_block(code, geometry=geometry, prove_mode="spot",
                                spot_types=chain_types, contracts=contracts,
                                cycle_limit=cycle_limit, source=source,
                                tower=True, recursion_cfg=recursion_cfg,
                                leaf_arity=leaf_arity,
                                block_number=block_number,
                                eip4844_outputs=blob_outputs,
                                eip4844_slots=eip4844_slots,
                                type_workers=type_workers, device=device)
    say("tower proven through the DAG (blob slots verified in-scheduler)")

    base_proofs: Dict[int, List[pk.PlonkishProof]] = {}
    for t in chain_types:
        n_inst = blk.artifacts.per_circuit[t].num_instances
        proofs = []
        for i in range(n_inst):
            rec = blk.source.get_base_layer_proof(t, i)
            assert rec is not None and rec.get("real"), \
                f"base type {t} instance {i} was not really proven"
            proofs.append(rec["proof"])
        assert proofs, f"base type {t} produced no instances for this block"
        base_proofs[t] = proofs

    # -- collect the DAG's real tower records ---------------------------------
    rigs = blk.recursion_rigs
    leaves: Dict[int, StageProof] = {}
    nodes: Dict[int, StageProof] = {}
    for t in chain_types:
        chunk_proofs: List[pk.PlonkishProof] = []
        i = 0
        while True:
            rec = blk.source.get_leaf_layer_proof(t + 2, i)
            if rec is None:
                break
            assert rec.get("real"), f"leaf[{t}][{i}] was not really proven"
            chunk_proofs.append(rec["proof"])
            leaf_vk = rec["vk"]
            i += 1
        assert chunk_proofs, f"no leaf proofs recorded for type {t}"
        rq_tail = tuple(int(v) % P
                        for v in blk.artifacts.recursion_queues[t].tail)
        got_tail = tuple(int(v) % P
                         for v in chunk_proofs[-1].public_inputs[-12:])
        assert got_tail == rq_tail, \
            f"leaf tail diverged from the recursion queue for type {t}"
        leaves[t] = StageProof(proof=chunk_proofs[-1], vk=leaf_vk,
                               ir=rigs[("leaf_final", t)][0],
                               cfg=recursion_cfg)
        nrec = blk.source.get_node_layer_proof(t, 0, 0)
        assert nrec is not None and nrec.get("real")
        nodes[t] = StageProof(proof=nrec["proof"], vk=nrec["vk"],
                              ir=rigs[("node_final", t)][0],
                              cfg=recursion_cfg)
        say(f"tower[{t}]: {len(chunk_proofs)} leaves -> node")

    srec = blk.source.get_scheduler_proof()
    assert srec is not None and srec.get("real"), \
        "scheduler task did not produce a real proof"
    assert tuple(srec["types"]) == chain_types
    sched_proof = srec["proof"]
    sched_pi = list(srec["scheduler_pi"])
    scheduler = StageProof(proof=sched_proof, vk=srec["vk"],
                           ir=rigs[("scheduler",)][0], cfg=recursion_cfg)
    say("scheduler proven (block commitment bound)")

    # -- 5. compression + SNARK wrapper --------------------------------------
    final = snark = None
    if wrap:
        outer_cfgs = ({m: compression_cfg
                       for m in range(1, compression_layers + 1)}
                      if compression_cfg is not None else None)
        # `for_wrapper` hashes the FINAL mode's trees/transcript with the
        # Bn256 Poseidon2 sponge (the reference always does)
        chain = ly.CompressionChain(
            scheduler.ir, scheduler.cfg, scheduler.vk,
            outer_cfgs=outer_cfgs,
            wrapper_mode=compression_layers if for_wrapper else None,
            device=device)
        cfg = cmp.WrapperConfig(compression_layers=compression_layers)
        final = cmp.wrap_proof(sched_proof, sched_pi, cfg,
                               chain.prove_fn, chain.verify_fn,
                               source=blk.source)
        for mode, st in chain.stats.items():
            stats[f"compression_{mode}"] = st
        if for_wrapper:
            # the for-wrapper inner shape, so callers (and the full
            # in-SNARK tier below) can synthesize/check the WrapperCircuit
            # statement over the chain's proof (None on a chain resumed in
            # full, whose prove_fn never ran)
            try:
                final["fw_shape"] = chain.final_shape(compression_layers)
            except KeyError:
                final["fw_shape"] = None
        say("compression chain proven")
        # SNARK statement tiers (all real BN254 PLONK proofs, host ints):
        #   "pi"      — packs the scheduler commitment into the L1 input;
        #   "binding" — + an in-SNARK Poseidon2-BN254 digest binding the
        #               for-wrapper VK to the chunks (needs for_wrapper);
        #   "full"    — verifies the whole for-wrapper FRI proof in-SNARK
        #               (utils/snark_fri_verifier — the reference
        #               WrapperCircuit statement, wrapper.rs:108-275;
        #               minutes of host PLONK proving, so opt-in).
        watch = tracing.Stopwatch(device)
        if for_wrapper and snark_mode == "full":
            from .utils import snark_fri_verifier as sfv
            fw_ir, fw_cfg, fw_vk = chain.final_shape(compression_layers)
            psetup, snark_proof, _lay = sfv.wrap_fw_proof(
                fw_ir, fw_cfg, fw_vk, final["final_proof"])
            watch.lap("prove")
            assert sfv.verify_fw_wrapped(
                psetup.vk, snark_proof, expected_fw_vk=fw_vk,
                expected_inner_pis=final["final_proof"].public_inputs), \
                "full in-SNARK FRI verification failed"
            watch.lap("verify")
            assert int(snark_proof.public_inputs[-1]) == \
                int(final["snark_public_input"])
            snark = {"proof": snark_proof, "vk": psetup.vk, "mode": "full"}
            stats["snark"] = watch.done(gates=psetup.circuit.num_gates,
                                        n=psetup.vk.n, mode="full")
        elif for_wrapper and snark_mode == "binding":
            fw_vk = [int(v) for v in final["final_vk"]]
            bsetup, snark_proof = sw.wrap_with_binding(fw_vk, sched_pi)
            watch.lap("prove")
            assert sw.verify_binding_proof(
                bsetup.vk, snark_proof, expected_fw_vk=fw_vk,
                expected_scheduler_pi=sched_pi), \
                "binding SNARK wrapper failed verification"
            watch.lap("verify")
            assert int(snark_proof.public_inputs[len(fw_vk) + 4]) == \
                int(final["snark_public_input"])
            snark = {"proof": snark_proof, "vk": bsetup.vk,
                     "mode": "binding"}
            stats["snark"] = watch.done(gates=bsetup.circuit.num_gates,
                                        n=bsetup.vk.n, mode="binding")
        else:
            # the "pi" tier: packs the scheduler commitment into the L1
            # input
            wsetup = sw.wrapper_setup()
            watch.lap("setup")
            snark_proof = sw.wrap_scheduler_pi(wsetup, sched_pi)
            watch.lap("prove")
            assert sw.verify_wrapped_proof(wsetup.vk, snark_proof,
                                           expected_scheduler_pi=sched_pi), \
                "SNARK wrapper proof failed verification"
            watch.lap("verify")
            assert int(snark_proof.public_inputs[-1]) == \
                int(final["snark_public_input"])
            stats["snark"] = watch.done(gates=wsetup.circuit.num_gates,
                                        n=wsetup.vk.n, mode="pi")
            snark = {"proof": snark_proof, "vk": wsetup.vk, "mode": "pi"}
        say(f"SNARK wrapper proven (mode={snark.get('mode')})")

    return FullChainResult(
        block=blk, chain_types=chain_types, base_proofs=base_proofs,
        leaves=leaves, nodes=nodes, scheduler=scheduler, scheduler_pi=sched_pi,
        final=final, snark=snark, eip4844=eip4844_records, stats=stats)
