"""Scheduler circuit: the block-level aggregation root.

Counterpart of the JAX package's `circuits/scheduler_circuit.py`, the same
synthesis over the port's builder. The host-side block commitment
(`scheduler_public_inputs`, `scheduler_multi_public_inputs`) is hashed on
`device` (`None`: the CUDA card, raising where there is none).

The reference scheduler
(circuit_definitions/src/circuit_definitions/recursion_layer/scheduler.rs)
verifies, per base-circuit type, the node proof that aggregates that type's
recursion queue; checks the queue was consumed from EMPTY head to its final
tail; and compresses the block's observable data plus all verification-key
material into a single public-input commitment — the value the compression
chain and the SNARK wrapper ultimately expose on L1.

Synthesized here with the gadget builder over the node-circuit PI convention
(circuits/node_circuit.py):

  node PIs = [leaf VK || base VK of the aggregated type || head (4) || tail (12)]

In-circuit statement, for types t_1..t_k (a synthesis parameter — production
all 13, tests fewer):
  - one `synthesize_proof_check` per type against a SHARED node VK;
  - every node proof's head capacity lanes are ZERO (each type's recursion
    queue is consumed whole, from the empty state);
  - every node proof embeds the SAME leaf VK (leaf_vk_len is a synthesis
    parameter);
  - the block commitment  digest = hash_elements([block_number || aux
    observables || node VK || leaf VK || (type_id || base VK_t || tail_t)
    per type])  is recomputed in-circuit and exposed as the circuit's ONLY
    public inputs (4 lanes) — the closed-form block commitment
    (external_calls.rs:250-540 scheduler-witness contents).

Aux observables are the scheduler witness's block-glue values (memory/events
queue tails, state-diff + L1-linear keccak hashes as u32 limbs), passed as a
flat field-element vector.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..prover import plonkish as pk
from . import builder as bd
from . import verifier_circuit as vc

P = gl.P
T = 12
QUEUE_SUFFIX = 4 + T


@dataclasses.dataclass
class SchedulerLayout:
    builder: bd.CircuitBuilder
    type_ids: List[int]
    child_layouts: List[vc.VerifierLayout]
    node_vk_vars: List[int]
    block_number_var: int
    aux_vars: List[int]
    leaf_vk_len: int
    prefix_len: int


def synthesize_scheduler(node_ir: pk.PlonkishIR, node_cfg: pk.PlonkishConfig,
                         type_ids: Sequence[int], leaf_vk_len: int,
                         aux_len: int = 0, slots: int = 8
                         ) -> Tuple[bd.CircuitBuilder, SchedulerLayout]:
    n_child_pis = len(node_ir.public_input_cells)
    prefix_len = n_child_pis - QUEUE_SUFFIX
    assert 0 < leaf_vk_len <= prefix_len
    sh = vc.inner_shape(node_ir, node_cfg)
    b = bd.CircuitBuilder(slots=slots)
    node_vk_vars = b.inputs(sh.cap_size * vc.DIGEST)
    block_number_var = b.input()
    aux_vars = b.inputs(aux_len)

    child_layouts = []
    for _ in type_ids:
        lay = vc.synthesize_proof_check(b, node_ir, node_cfg,
                                        vk_vars=node_vk_vars)
        child_layouts.append(lay)

    # every type's queue is consumed from the EMPTY state
    for lay in child_layouts:
        for k in range(4):
            b.assert_zero(lay.inner_pi_vars[prefix_len + k])
    # one leaf VK across all aggregated types
    pi0 = child_layouts[0].inner_pi_vars
    for lay in child_layouts[1:]:
        for j in range(leaf_vk_len):
            b.assert_eq(lay.inner_pi_vars[j], pi0[j])

    absorb = [block_number_var] + list(aux_vars) + list(node_vk_vars)
    absorb += pi0[:leaf_vk_len]
    for tid, lay in zip(type_ids, child_layouts):
        absorb.append(b.constant(int(tid)))
        absorb += lay.inner_pi_vars[leaf_vk_len:prefix_len]   # base VK_t
        absorb += lay.inner_pi_vars[prefix_len + 4:]          # tail_t (12)
    digest = vc.hash_row(b, absorb)
    for v in digest:
        b.mark_public(v)
    return b, SchedulerLayout(builder=b, type_ids=list(type_ids),
                              child_layouts=child_layouts,
                              node_vk_vars=node_vk_vars,
                              block_number_var=block_number_var,
                              aux_vars=aux_vars, leaf_vk_len=leaf_vk_len,
                              prefix_len=prefix_len)


def scheduler_assignments(lay: SchedulerLayout, node_vk: Sequence[int],
                          node_proofs: Sequence[pk.PlonkishProof],
                          block_number: int,
                          aux_values: Sequence[int] = ()) -> Dict[int, int]:
    assert len(node_proofs) == len(lay.child_layouts)
    asg: Dict[int, int] = {lay.block_number_var: int(block_number) % P}
    assert len(aux_values) == len(lay.aux_vars)
    for var, val in zip(lay.aux_vars, aux_values):
        asg[var] = int(val) % P
    for child_lay, proof in zip(lay.child_layouts, node_proofs):
        asg.update(vc.verifier_assignments(child_lay, node_vk, proof))
    return asg


def scheduler_public_inputs(lay: SchedulerLayout, node_vk: Sequence[int],
                            node_proofs: Sequence[pk.PlonkishProof],
                            block_number: int,
                            aux_values: Sequence[int] = (),
                            device=None) -> List[int]:
    """The block commitment, recomputed host-side with the SAME
    hash_elements chain the circuit replays."""
    device = gl.resolve_device(device)
    pl, lvl = lay.prefix_len, lay.leaf_vk_len
    absorb = [int(block_number) % P]
    absorb += [int(v) % P for v in aux_values]
    absorb += [int(v) % P for v in node_vk]
    pis0 = [int(v) % P for v in node_proofs[0].public_inputs]
    absorb += pis0[:lvl]
    for tid, proof in zip(lay.type_ids, node_proofs):
        pis = [int(v) % P for v in proof.public_inputs]
        absorb.append(int(tid))
        absorb += pis[lvl:pl]
        absorb += pis[pl + 4:]
    digest = gl.to_ints(p2.hash_elements(gl.from_int(absorb, device)))
    return [int(v) for v in digest]


@dataclasses.dataclass
class SchedulerMultiLayout:
    """Scheduler over HETEROGENEOUS node children: one verifier slot per
    base type, each with its OWN node IR/config/VK vars (the full-chain
    shape, where every type's leaf — and hence node — circuit differs
    because its inner base circuit differs), plus one verifier slot per
    EIP-4844 blob fold proof (the reference scheduler consumes
    eip4844_proofs + VK in its witness and verifies them in-circuit —
    src/tests/complex_tests/mod.rs:993-1007, external_calls.rs:529)."""
    builder: bd.CircuitBuilder
    type_ids: List[int]
    child_layouts: List[vc.VerifierLayout]
    node_vk_vars: List[List[int]]
    block_number_var: int
    aux_vars: List[int]
    prefix_lens: List[int]
    blob_layouts: List[vc.VerifierLayout] = dataclasses.field(
        default_factory=list)
    blob_vk_vars: List[List[int]] = dataclasses.field(default_factory=list)


BLOB_SLOT_TAG = 4844  # domain-separates blob slots in the commitment absorb


def synthesize_scheduler_multi(children: Sequence[Tuple[pk.PlonkishIR,
                                                        pk.PlonkishConfig]],
                               type_ids: Sequence[int], aux_len: int = 0,
                               slots: int = 8,
                               blob_children: Sequence[
                                   Tuple[pk.PlonkishIR,
                                         pk.PlonkishConfig]] = ()
                               ) -> Tuple[bd.CircuitBuilder,
                                          SchedulerMultiLayout]:
    """Block-level aggregation root over per-type node proofs of DIFFERENT
    shapes. In-circuit statement, per type t:
      - verify node proof t against its own (public, committed) node VK;
      - its queue head capacity lanes are ZERO (queue consumed whole);
      - absorb [t || node VK_t || node PI prefix_t (leaf VK_t + base VK_t)
        || tail_t] into the block commitment.
    Per EIP-4844 blob slot b (one per blob, `blob_children` gives each fold
    circuit's shape):
      - verify the blob's fold proof against its own (committed) VK;
      - absorb [BLOB_SLOT_TAG || fold VK_b || fold PIs_b (binding
        challenges, binding accumulator, evaluation-point limbs, opening
        limbs)] into the block commitment — so the commitment
        cryptographically attests the blob openings, not just their
        host-computed output hashes.
    The 4-lane Poseidon2 commitment is the circuit's only public output
    (plus block number/aux bound inside it)."""
    assert len(children) == len(type_ids)
    b = bd.CircuitBuilder(slots=slots)
    block_number_var = b.input()
    aux_vars = b.inputs(aux_len)
    node_vk_vars: List[List[int]] = []
    child_layouts: List[vc.VerifierLayout] = []
    prefix_lens: List[int] = []
    for node_ir, node_cfg in children:
        n_child_pis = len(node_ir.public_input_cells)
        prefix_lens.append(n_child_pis - QUEUE_SUFFIX)
        sh = vc.inner_shape(node_ir, node_cfg)
        vk_vars = b.inputs(sh.cap_size * vc.DIGEST)
        node_vk_vars.append(vk_vars)
        lay = vc.synthesize_proof_check(b, node_ir, node_cfg,
                                        vk_vars=vk_vars)
        child_layouts.append(lay)
    blob_vk_vars: List[List[int]] = []
    blob_layouts: List[vc.VerifierLayout] = []
    for blob_ir, blob_cfg in blob_children:
        sh = vc.inner_shape(blob_ir, blob_cfg)
        vk_vars = b.inputs(sh.cap_size * vc.DIGEST)
        blob_vk_vars.append(vk_vars)
        lay = vc.synthesize_proof_check(b, blob_ir, blob_cfg,
                                        vk_vars=vk_vars)
        blob_layouts.append(lay)

    absorb = [block_number_var] + list(aux_vars)
    for tid, lay, vk_vars, pl in zip(type_ids, child_layouts, node_vk_vars,
                                     prefix_lens):
        for k in range(4):  # queue consumed from the EMPTY state
            b.assert_zero(lay.inner_pi_vars[pl + k])
        absorb.append(b.constant(int(tid)))
        absorb += vk_vars
        absorb += lay.inner_pi_vars[:pl]       # leaf VK_t || base VK_t
        absorb += lay.inner_pi_vars[pl + 4:]   # tail_t (12)
    for lay, vk_vars in zip(blob_layouts, blob_vk_vars):
        absorb.append(b.constant(BLOB_SLOT_TAG))
        absorb += vk_vars
        absorb += lay.inner_pi_vars
    digest = vc.hash_row(b, absorb)
    for v in digest:
        b.mark_public(v)
    return b, SchedulerMultiLayout(
        builder=b, type_ids=list(type_ids), child_layouts=child_layouts,
        node_vk_vars=node_vk_vars, block_number_var=block_number_var,
        aux_vars=aux_vars, prefix_lens=prefix_lens,
        blob_layouts=blob_layouts, blob_vk_vars=blob_vk_vars)


def scheduler_multi_assignments(lay: SchedulerMultiLayout,
                                node_vks: Sequence[Sequence[int]],
                                node_proofs: Sequence[pk.PlonkishProof],
                                block_number: int,
                                aux_values: Sequence[int] = (),
                                blob_vks: Sequence[Sequence[int]] = (),
                                blob_proofs: Sequence[pk.PlonkishProof] = ()
                                ) -> Dict[int, int]:
    assert len(node_proofs) == len(lay.child_layouts) == len(node_vks)
    assert len(blob_proofs) == len(lay.blob_layouts) == len(blob_vks)
    asg: Dict[int, int] = {lay.block_number_var: int(block_number) % P}
    assert len(aux_values) == len(lay.aux_vars)
    for var, val in zip(lay.aux_vars, aux_values):
        asg[var] = int(val) % P
    for child_lay, vk, proof in zip(lay.child_layouts, node_vks,
                                    node_proofs):
        asg.update(vc.verifier_assignments(child_lay, vk, proof))
    for blob_lay, vk, proof in zip(lay.blob_layouts, blob_vks, blob_proofs):
        asg.update(vc.verifier_assignments(blob_lay, vk, proof))
    return asg


def scheduler_multi_public_inputs(lay: SchedulerMultiLayout,
                                  node_vks: Sequence[Sequence[int]],
                                  node_proofs: Sequence[pk.PlonkishProof],
                                  block_number: int,
                                  aux_values: Sequence[int] = (),
                                  blob_vks: Sequence[Sequence[int]] = (),
                                  blob_proofs: Sequence[pk.PlonkishProof] = (),
                                  device=None) -> List[int]:
    """The block commitment, recomputed host-side with the SAME
    hash_elements chain the circuit replays."""
    device = gl.resolve_device(device)
    absorb = [int(block_number) % P]
    absorb += [int(v) % P for v in aux_values]
    for tid, vk, proof, pl in zip(lay.type_ids, node_vks, node_proofs,
                                  lay.prefix_lens):
        pis = [int(v) % P for v in proof.public_inputs]
        absorb.append(int(tid))
        absorb += [int(v) % P for v in vk]
        absorb += pis[:pl]
        absorb += pis[pl + 4:]
    for vk, proof in zip(blob_vks, blob_proofs):
        absorb.append(BLOB_SLOT_TAG)
        absorb += [int(v) % P for v in vk]
        absorb += [int(v) % P for v in proof.public_inputs]
    digest = gl.to_ints(p2.hash_elements(gl.from_int(absorb, device)))
    return [int(v) for v in digest]


def scheduler_aux_values(sched_wit) -> List[int]:
    """Flatten a SchedulerCircuitInstanceWitness's observable block data into
    the aux field-element vector (u32 limbs for the keccak byte hashes)."""
    out: List[int] = []
    out += [int(v) % P for v in sched_wit.bootloader_heap_initial_content]
    out += [int(v) % P for v in sched_wit.events_queue_state.tail]
    out.append(int(sched_wit.events_queue_state.length))
    out += [int(v) % P for v in sched_wit.memory_queue_state.tail]
    out.append(int(sched_wit.memory_queue_state.length))
    for h in (sched_wit.aux_output.rollup_state_diff_for_compression,
              sched_wit.aux_output.l1_messages_linear_hash):
        out += [int.from_bytes(h[i:i + 4], "big") for i in range(0, 32, 4)]
    # EIP-4844 blob output commitments: the block commitment BINDS each
    # blob's keccak(versioned_hash || evaluation_point || opening_value)
    # exactly like the reference scheduler consumes them
    for h in getattr(sched_wit, "eip4844_output_hashes", ()):
        out += [int.from_bytes(h[i:i + 4], "big") for i in range(0, 32, 4)]
    return out
