"""Node aggregation circuit: verify K child recursion proofs in-circuit and
splice their recursion-queue segments.

Counterpart of the JAX package's `circuits/node_circuit.py`, the same
synthesis over the port's builder.

The reference node circuit
(circuit_definitions/src/circuit_definitions/recursion_layer/node_layer.rs)
verifies RECURSION_ARITY child proofs — leaf proofs at depth 0, node proofs
deeper — against a shared VK and exposes the spliced queue interval. Here the
same statement is synthesized with the gadget builder, uniformly over the
child PI convention established by circuits/leaf_circuit.py:

  child PIs = [prefix ... || queue head capacity lanes (4) || queue tail (12)]

(for a leaf child the prefix is the base-layer VK it verified; for a node
child it is [child VK || base VK] — the node is layout-agnostic and only
requires the prefix to AGREE across children).

In-circuit constraints:
  - one `synthesize_proof_check` per child, all sharing the SAME in-circuit
    VK variables (a child proven under a different VK cannot satisfy the
    shared transcript replay);
  - prefix agreement: every child's PI prefix equals child 0's;
  - queue splicing: child i's head capacity lanes equal child i-1's tail
    capacity lanes (tail[8:12]) — the recursion queue is consumed in one
    contiguous interval;
  - node public inputs: [child VK || common prefix || child 0's head (4) ||
    last child's tail (12)] — the same [.. head || tail] convention, so
    nodes stack on nodes unchanged.

Arity is a synthesis parameter (production RECURSION_ARITY = 32,
recursion_layer/mod.rs:25; tests use small K).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from ..ops import goldilocks as gl
from ..prover import plonkish as pk
from . import builder as bd
from . import verifier_circuit as vc

P = gl.P
T = 12
QUEUE_SUFFIX = 4 + T  # head capacity lanes + full tail


@dataclasses.dataclass
class NodeLayout:
    builder: bd.CircuitBuilder
    child_layouts: List[vc.VerifierLayout]
    vk_vars: List[int]
    prefix_len: int


def synthesize_node(child_ir: pk.PlonkishIR, child_cfg: pk.PlonkishConfig,
                    arity: int, slots: int = 8
                    ) -> Tuple[bd.CircuitBuilder, NodeLayout]:
    n_child_pis = len(child_ir.public_input_cells)
    assert n_child_pis >= QUEUE_SUFFIX, \
        "child PI layout must end with [head(4) || tail(12)]"
    prefix_len = n_child_pis - QUEUE_SUFFIX
    sh = vc.inner_shape(child_ir, child_cfg)
    b = bd.CircuitBuilder(slots=slots)
    vk_vars = b.inputs(sh.cap_size * vc.DIGEST)

    child_layouts = []
    for _ in range(arity):
        lay = vc.synthesize_proof_check(b, child_ir, child_cfg,
                                        vk_vars=vk_vars)
        child_layouts.append(lay)

    pi0 = child_layouts[0].inner_pi_vars
    for lay in child_layouts[1:]:
        for j in range(prefix_len):
            b.assert_eq(lay.inner_pi_vars[j], pi0[j])
    # queue splicing: child i's head caps == child i-1's tail caps
    for i in range(1, arity):
        prev_tail = child_layouts[i - 1].inner_pi_vars[prefix_len + 4:]
        head = child_layouts[i].inner_pi_vars[prefix_len:prefix_len + 4]
        for k in range(4):
            b.assert_eq(head[k], prev_tail[8 + k])

    last_tail = child_layouts[-1].inner_pi_vars[prefix_len + 4:]
    for v in (vk_vars + pi0[:prefix_len]
              + pi0[prefix_len:prefix_len + 4] + list(last_tail)):
        b.mark_public(v)
    return b, NodeLayout(builder=b, child_layouts=child_layouts,
                         vk_vars=vk_vars, prefix_len=prefix_len)


def node_assignments(lay: NodeLayout, child_vk: Sequence[int],
                     child_proofs: Sequence[pk.PlonkishProof]
                     ) -> Dict[int, int]:
    assert len(child_proofs) == len(lay.child_layouts), \
        "node arity mismatch (pad with repeated proofs or resynthesize)"
    asg: Dict[int, int] = {}
    for child_lay, proof in zip(lay.child_layouts, child_proofs):
        asg.update(vc.verifier_assignments(child_lay, child_vk, proof))
    return asg


def node_public_inputs(lay: NodeLayout, child_vk: Sequence[int],
                       child_proofs: Sequence[pk.PlonkishProof]) -> List[int]:
    pl = lay.prefix_len
    first = [int(v) % P for v in child_proofs[0].public_inputs]
    last = [int(v) % P for v in child_proofs[-1].public_inputs]
    out = [int(v) % P for v in child_vk]
    out += first[:pl]
    out += first[pl:pl + 4]
    out += last[pl + 4:]
    return out
