"""EIP-4844 equivalence circuit: the blob opening proven in BLS12-381 Fr.

The reference circuit (src/utils.rs:233-270, zkevm_circuits eip4844,
EIP4844_CYCLE_LIMIT = 4096) proves that the claimed blob opening value is
the Horner fold of the blob's 31-byte chunks at the Fiat-Shamir evaluation
point — the field-arithmetic half of the blob equivalence argument (the
keccak linear hash of the blob is the type-13 hasher core's job, and the
KZG side is checked on L1). This module proves the FOLD with the
foreign-field row core (circuits/ffarith.py):

    opening = e_0 * x^(n-1) + e_1 * x^(n-2) + ... + e_{n-1}   (mod Fr)

  - row 0 canonicalizes the evaluation point x (an input row);
  - row 1 loads e_0 (a bound free addend); rows 2..n fold
    acc = acc*x + e_i, each e_i a FREE C operand bound by the circuit's
    binding-fingerprint accumulator (challenge-after-commit over the blob
    elements — the cross-circuit glue to the keccak'd blob bytes);
  - public inputs: [fp challenge, fp gamma, fp acc_in, fp acc_out] then
    the limbs of x and of the opening value.

Counterpart of the JAX package's `circuits/eip4844_circuit.py`, on the port's
`circuits/ffarith.py`. The binding challenges are drawn and the witness is
built on `device` (`None` means the CUDA card, raising where there is none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops import goldilocks as gl
from ..utils.bls12_381 import R as FR_MODULUS
from . import ffarith as ff

P = gl.P


def ff_params(limb_bits: int = 16) -> ff.FFParams:
    nl = -(-256 // limb_bits)
    return ff.FFParams(modulus=FR_MODULUS, limb_bits=limb_bits,
                       num_limbs=nl)


@dataclasses.dataclass
class Eip4844Program:
    params: ff.FFParams
    n_elements: int
    layout: ff.FFLayout
    x_var: ff.FFVar
    out_var: ff.FFVar
    x_row: int
    e_rows: List[int]


def build_eip4844_program(n_elements: int,
                          limb_bits: int = 16) -> Eip4844Program:
    par = ff_params(limb_bits)
    prog = ff.FFProgram(par)
    x = prog.input()
    acc = prog.fma_bound(None, None, b_const=0)   # acc_0 = e_0
    e_rows = [acc.row]
    for _ in range(n_elements - 1):
        acc = prog.fma_bound(acc, x)              # acc = acc*x + e_i
        e_rows.append(acc.row)
    layout = ff.build_ff_layout(prog, public_results=(x, acc))
    return Eip4844Program(params=par, n_elements=n_elements, layout=layout,
                          x_var=x, out_var=acc, x_row=0, e_rows=e_rows)


def draw_blob_challenges(elements: Sequence[int], device=None
                         ) -> Tuple[int, int]:
    """Fiat-Shamir binding challenges over the blob elements."""
    from ..ops import poseidon2 as p2
    from ..prover.transcript import Transcript
    device = gl.resolve_device(device)
    tr = Transcript(domain_tag=4844, device=device)
    flat = []
    for e in elements:
        flat += [v % P for v in
                 [(int(e) >> (32 * i)) & 0xFFFFFFFF for i in range(8)]]
    digest = gl.to_ints(p2.hash_elements(gl.from_int(flat or [0], device)))
    tr.absorb_ints([int(v) for v in digest] + [len(elements)])
    return tr.challenge_base(), tr.challenge_base()


def horner_fold(elements: Sequence[int], x: int) -> int:
    acc = 0
    for i, e in enumerate(elements):
        acc = (acc + int(e)) % FR_MODULUS
        if i != len(elements) - 1:
            acc = acc * (int(x) % FR_MODULUS) % FR_MODULUS
    return acc


@dataclasses.dataclass
class Eip4844InstanceInputs:
    elements: List[int]   # blob chunks as Fr integers, chunk 0 first
    x: int                # evaluation point
    challenge: int
    gamma: int


def instance_inputs(elements: Sequence[int], x: int,
                    challenge: Optional[int] = None,
                    gamma: Optional[int] = None,
                    device=None) -> Eip4844InstanceInputs:
    if challenge is None or gamma is None:
        challenge, gamma = draw_blob_challenges(elements, device)
    return Eip4844InstanceInputs(elements=[int(e) % FR_MODULUS
                                           for e in elements],
                                 x=int(x) % FR_MODULUS,
                                 challenge=challenge, gamma=gamma)


def eip4844_witness(prog: Eip4844Program, ir, inst: Eip4844InstanceInputs,
                    device=None) -> gl.GF:
    assert len(inst.elements) == prog.n_elements
    inputs: Dict[Tuple[int, str], int] = {(prog.x_row, "A"): inst.x}
    for row, e in zip(prog.e_rows, inst.elements):
        inputs[(row, "C")] = int(e)
    return ff.ff_witness(prog.layout, ir, inputs,
                         binding=(inst.challenge, inst.gamma), device=device)


def expected_public_inputs(prog: Eip4844Program,
                           inst: Eip4844InstanceInputs) -> List[int]:
    par = prog.params
    acc = ff.binding_accumulator(par, inst.challenge, inst.gamma,
                                 inst.elements)
    opening = horner_fold(inst.elements, inst.x)
    out = [inst.challenge % P, inst.gamma % P, 1, acc]
    out += par.split(inst.x % FR_MODULUS)
    out += par.split(opening)
    return out


def opening_value(prog: Eip4844Program, pis: Sequence[int]) -> int:
    """Recover the proven opening value from the PI limbs."""
    nl = prog.params.num_limbs
    return prog.params.join([int(v) for v in pis[4 + nl:4 + 2 * nl]])
