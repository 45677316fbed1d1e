"""Circuit post-processing: closed-form inputs, PI commitments, CircuitMaker.

Counterpart of the JAX package's `witness/postprocessing.py`. The
commitments and the recursion queue are hashed on `device` (`None`: the
CUDA card, raising where there is none).

Parity with src/witness/postprocessing/mod.rs:94-420 (SURVEY component 8) and
`simulate_public_input_value_from_witness` (src/witness/utils.rs:269-308):

  - every circuit instance carries a `ClosedFormInput`: start/completion
    flags, hidden FSM input/output (continuation state between instances of
    a split argument), and observable input/output (the values the scheduler
    checks across circuits);
  - the instance's public input is a Poseidon2 commitment of the compact
    form of that structure;
  - `CircuitMaker` processes instances of one circuit type in order, pins
    the shared observable input, chains FSM states, pushes a
    `RecursionRequest(type, public_input)` per instance into the per-type
    recursion queue, and tracks the first/last instances (the scheduler
    consumes exactly those — `BlockFirstAndLastBasicCircuits`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from .recursion import RecursionQueueSimulator, RecursionRequest

P = gl.P


@dataclasses.dataclass
class ClosedFormInput:
    start_flag: bool
    completion_flag: bool
    observable_input: Tuple[int, ...]
    observable_output: Tuple[int, ...]
    hidden_fsm_input: Tuple[int, ...]
    hidden_fsm_output: Tuple[int, ...]

    def compact_form(self) -> List[int]:
        """Flatten to field elements (the compact form that gets committed)."""
        out = [1 if self.start_flag else 0, 1 if self.completion_flag else 0]
        for part in (self.observable_input, self.observable_output,
                     self.hidden_fsm_input, self.hidden_fsm_output):
            out.extend(int(v) % P for v in part)
        return out


def simulate_public_input_value(cfi: ClosedFormInput, device=None
                                ) -> Tuple[int, int, int, int]:
    """Poseidon2 commitment of the compact form (utils.rs:269-308 — the
    reference simulates this on a scratch CS; the commitment function is the
    same sponge the in-circuit version computes)."""
    digest = p2.hash_elements(gl.from_int(cfi.compact_form(),
                                          gl.resolve_device(device)))
    return tuple(int(v) for v in gl.to_u64(digest))


@dataclasses.dataclass
class CircuitInstance:
    circuit_type: int
    index: int
    closed_form_input: ClosedFormInput
    public_input: Tuple[int, int, int, int]
    witness_payload: object = None


class CircuitMaker:
    """Uniform per-instance flow for one circuit type."""

    def __init__(self, circuit_type: int, device=None):
        self.device = gl.resolve_device(device)
        self.circuit_type = int(circuit_type)
        self.instances: List[CircuitInstance] = []
        self.queue = RecursionQueueSimulator(device=self.device)
        self._observable_input: Optional[Tuple[int, ...]] = None
        self._prev_fsm: Optional[Tuple[int, ...]] = None

    def process(self, observable_input: Sequence[int],
                observable_output: Sequence[int],
                fsm_input: Sequence[int], fsm_output: Sequence[int],
                is_last: bool, witness_payload: object = None
                ) -> CircuitInstance:
        idx = len(self.instances)
        obs_in = tuple(int(v) % P for v in observable_input)
        if self._observable_input is None:
            self._observable_input = obs_in
        else:
            assert obs_in == self._observable_input, \
                "observable input must be shared across instances"
        fsm_in = tuple(int(v) % P for v in fsm_input)
        if self._prev_fsm is not None:
            assert fsm_in == self._prev_fsm, "FSM continuation broken"
        self._prev_fsm = tuple(int(v) % P for v in fsm_output)

        cfi = ClosedFormInput(
            start_flag=(idx == 0), completion_flag=is_last,
            observable_input=obs_in,
            observable_output=tuple(int(v) % P for v in observable_output),
            hidden_fsm_input=fsm_in,
            hidden_fsm_output=self._prev_fsm)
        pi = simulate_public_input_value(cfi, self.device)
        inst = CircuitInstance(self.circuit_type, idx, cfi, pi, witness_payload)
        self.instances.append(inst)
        self.queue.push_request(RecursionRequest(self.circuit_type, pi))
        return inst

    def process_real(self, cfi: ClosedFormInput,
                     real_public_inputs: Sequence[int],
                     witness_payload: object = None) -> CircuitInstance:
        """Process one instance carrying its REAL closed-form data
        (witness/closed_form.py) and its REAL proven public-input vector.

        The chain checks (shared observable input, FSM continuation) run
        over the real values; the recursion-queue digest is the Poseidon2
        hash of the real PI vector — exactly the digest the leaf circuit
        recomputes in-circuit from the child proof
        (circuits/leaf_circuit.py), so the DAG's queue IS the queue the
        recursion tower verifies."""
        idx = len(self.instances)
        if self._observable_input is None:
            self._observable_input = tuple(cfi.observable_input)
        else:
            if tuple(cfi.observable_input) != self._observable_input:
                raise ValueError("observable input must be shared across "
                                 f"instances of type {self.circuit_type}")
        if self._prev_fsm is not None and \
                tuple(cfi.hidden_fsm_input) != self._prev_fsm:
            raise ValueError(
                f"FSM continuation broken at instance {idx} of type "
                f"{self.circuit_type}: {cfi.hidden_fsm_input} != "
                f"{self._prev_fsm}")
        if bool(cfi.start_flag) != (idx == 0):
            raise ValueError("start flag must mark exactly the first "
                             "instance")
        self._prev_fsm = tuple(cfi.hidden_fsm_output)
        pis = [int(v) % P for v in real_public_inputs]
        digest = p2.hash_elements(gl.from_int(pis, self.device))
        pi = tuple(int(v) for v in gl.to_ints(digest))
        inst = CircuitInstance(self.circuit_type, idx, cfi, pi,
                               witness_payload)
        self.instances.append(inst)
        self.queue.push_request(RecursionRequest(self.circuit_type, pi))
        return inst

    @property
    def first(self) -> Optional[CircuitInstance]:
        return self.instances[0] if self.instances else None

    @property
    def last(self) -> Optional[CircuitInstance]:
        return self.instances[-1] if self.instances else None


@dataclasses.dataclass
class BlockFirstAndLastBasicCircuits:
    """First/last instance per base type (external_calls.rs scheduler skeleton
    consumes these closed-form inputs)."""

    per_type: dict  # circuit_type -> (first, last) CircuitInstance
