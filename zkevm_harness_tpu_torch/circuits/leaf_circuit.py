"""Leaf aggregation circuit: verify K child proofs in-circuit + absorb their
public-input commitments into the recursion queue.

Counterpart of the JAX package's `circuits/leaf_circuit.py`, the same
synthesis over the port's builder. The host-side queue replay
(`advance_queue_head`, `leaf_public_inputs`) runs on `device` (`None`: the
CUDA card, raising where there is none).

The reference leaf circuit
(circuit_definitions/src/circuit_definitions/recursion_layer/leaf_layer.rs)
verifies RECURSION_ARITY = 32 base-layer proofs of one circuit type against a
shared VK and consumes the corresponding segment of that type's recursion
queue. Here the same statement is synthesized with the gadget builder:

  - one `synthesize_proof_check` instance per child, all sharing the SAME
    in-circuit VK variables (a child proven under a different VK cannot
    satisfy the shared transcript replay);
  - per child: a Poseidon2 digest of its public inputs, pushed into a
    full-width recursion-queue sponge as [circuit_type, digest(4), 0, 0, 0]
    — exactly RecursionRequest.encode (witness/recursion.py:42) under
    FullWidthQueueSimulator semantics (state' = P2(overwrite(state, enc)));
  - circuit public inputs: [child VK || queue head capacity lanes (4) ||
    queue tail (12)],
    so node layers chain leaves by equating tails to heads, and the VK
    binding is public.

Arity is a synthesis parameter (production 32; tests use small K — the
circuit is uniform in K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..prover import plonkish as pk
from ..witness.recursion import RecursionQueueSimulator, RecursionRequest
from . import builder as bd
from . import verifier_circuit as vc

P = gl.P
T = 12


@dataclasses.dataclass
class LeafLayout:
    builder: bd.CircuitBuilder
    child_layouts: List[vc.VerifierLayout]
    vk_vars: List[int]
    head_vars: List[int]
    tail_vars: List[int]
    base_circuit_type: int
    flag_vars: List[int] = dataclasses.field(default_factory=list)

    @property
    def padded(self) -> bool:
        return bool(self.flag_vars)


def synthesize_leaf(inner_ir: pk.PlonkishIR, inner_cfg: pk.PlonkishConfig,
                    arity: int, base_circuit_type: int,
                    slots: int = 8, padded: bool = False
                    ) -> Tuple[bd.CircuitBuilder, LeafLayout]:
    """With `padded=True` the circuit supports RAGGED chunks at a FIXED
    arity (one shared VK across all chunks of a type — the reference pads
    leaf chunks to RECURSION_ARITY with padding proofs,
    src/witness/recursive_aggregation.rs:385-389 + data-source
    padding-proof slots): every slot still verifies a proof under the
    shared VK, but slot i's queue push is gated by a boolean flag f_i
    (monotone: once padding, all later slots are padding), so the exposed
    tail is the sponge state after the LAST REAL push. Flag soundness
    comes from the tail itself: skipping a real digest (or pushing a
    padding one) produces a tail that diverges from the host recursion
    queue, which the node/scheduler chain pins."""
    sh = vc.inner_shape(inner_ir, inner_cfg)
    b = bd.CircuitBuilder(slots=slots)
    vk_vars = b.inputs(sh.cap_size * vc.DIGEST)
    # only the capacity lanes of the head influence the chain (the rate lanes
    # are overwritten by the first push), so the head PI is head[8:12]
    head_vars = b.inputs(4)
    ct = b.constant(int(base_circuit_type))

    child_layouts = []
    flag_vars: List[int] = []
    cap_lanes = list(head_vars)
    state = None
    tail_state = None
    prev_flag = None
    for i in range(arity):
        lay = vc.synthesize_proof_check(b, inner_ir, inner_cfg,
                                        vk_vars=vk_vars)
        child_layouts.append(lay)
        digest = vc.hash_row(b, lay.inner_pi_vars)
        enc = [ct] + list(digest) + [b.zero] * 3
        state = b.poseidon2(enc + cap_lanes)
        if padded:
            fi = b.input()
            b.assert_bool(fi)
            if i == 0:
                b.assert_eq(fi, b.constant(1))  # >= 1 real proof per chunk
            else:
                # monotone: f_i * (1 - f_{i-1}) == 0
                b.assert_zero(b.mul(fi, b.sub(b.constant(1), prev_flag)))
            flag_vars.append(fi)
            prev_flag = fi
            new_tail = ([b.mux(fi, state[j], tail_state[j])
                         for j in range(T)] if tail_state is not None
                        else list(state))
            tail_state = new_tail
            cap_lanes = tail_state[8:12]
        else:
            tail_state = list(state)
            cap_lanes = state[8:12]

    for v in vk_vars + head_vars + tail_state:
        b.mark_public(v)
    return b, LeafLayout(builder=b, child_layouts=child_layouts,
                         vk_vars=vk_vars, head_vars=head_vars,
                         tail_vars=tail_state,
                         base_circuit_type=base_circuit_type,
                         flag_vars=flag_vars)


def leaf_assignments(lay: LeafLayout, vk: Sequence[int],
                     child_proofs: Sequence[pk.PlonkishProof],
                     queue_head: Sequence[int] = (0,) * T,
                     padding_proof: Optional[pk.PlonkishProof] = None
                     ) -> Dict[int, int]:
    arity = len(lay.child_layouts)
    m = len(child_proofs)
    if m < arity:
        assert lay.padded, \
            "leaf arity mismatch (synthesize with padded=True for ragged " \
            "chunks)"
        pad = padding_proof if padding_proof is not None else child_proofs[0]
        child_proofs = list(child_proofs) + [pad] * (arity - m)
    else:
        assert m == arity, "more proofs than leaf slots"
    asg: Dict[int, int] = {}
    for var, val in zip(lay.head_vars, list(queue_head)[8:12]):
        asg[var] = int(val) % P
    for i, fi in enumerate(lay.flag_vars):
        asg[fi] = 1 if i < m else 0
    for child_lay, proof in zip(lay.child_layouts, child_proofs):
        asg.update(vc.verifier_assignments(child_lay, vk, proof))
    return asg


def _queue_after(queue_head: Sequence[int], base_circuit_type: int,
                 child_proofs: Sequence[pk.PlonkishProof], device):
    """The recursion queue from `queue_head` after pushing each child's
    public-input digest, the same RecursionQueueSimulator the oracle uses."""
    q = RecursionQueueSimulator(head=tuple(int(v) % P for v in queue_head),
                                width=8, device=device)
    for proof in child_proofs:
        pis = [int(v) % P for v in proof.public_inputs]
        digest = tuple(int(v) for v in gl.to_ints(
            p2.hash_elements(gl.from_int(pis, device))))
        q.push_request(RecursionRequest(base_circuit_type, digest))
    return q


def advance_queue_head(queue_head: Sequence[int], base_circuit_type: int,
                       child_proofs: Sequence[pk.PlonkishProof],
                       device=None) -> Tuple[int, ...]:
    """The full 12-lane recursion-queue state after pushing this chunk's
    closed-form-input digests: the next leaf chunk's queue head (the
    reference splits at RECURSION_ARITY and chains heads the same way,
    src/witness/recursive_aggregation.rs:71-161)."""
    device = gl.resolve_device(device)
    q = _queue_after(queue_head, base_circuit_type, child_proofs, device)
    return tuple(int(v) for v in q.tail)


def leaf_public_inputs(lay: LeafLayout, vk: Sequence[int],
                       child_proofs: Sequence[pk.PlonkishProof],
                       queue_head: Sequence[int] = (0,) * T,
                       device=None) -> List[int]:
    """Expected PIs, with the queue tail recomputed host-side via the SAME
    RecursionQueueSimulator the oracle uses."""
    device = gl.resolve_device(device)
    q = _queue_after(queue_head, lay.base_circuit_type, child_proofs, device)
    out = [int(v) % P for v in vk]
    out += [int(v) % P for v in list(queue_head)[8:12]]
    out += [int(v) for v in q.tail]
    return out
