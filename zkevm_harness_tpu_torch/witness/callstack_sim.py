"""Callstack sponge simulation + per-frame storage-log detailed state.

Counterpart of the JAX package's `witness/callstack_sim.py`. The sponge is
serial: each push absorbs one width-32 encoding into the one 12-lane state
(four permutations of a lone state, as `draw_vm_challenges` does), on
`device` (`None`: the CUDA card, raising where there is none).

Parity targets (VERDICT r2 missing #7):
  - `FullWidthStackSimulator` (circuit_encodings/src/lib.rs stack flavor):
    a Poseidon2 sponge STACK — push absorbs the entry encoding into the
    running 12-lane state; pop restores the recorded pre-push state and
    emits it as a witness (the circuit re-checks the hash on pop, so a
    forged pop state cannot re-produce the parent chain);
  - `CallstackSimulator` (src/witness/oracle.rs:560-790 +
    callstack_handler.rs:26-457): runs the stack simulator over the
    traced context pushes/pops, encoding each saved frame with
    encode_extended_callstack_entry together with its rollback-queue
    boundary (head/tail/segment length), and reconstructs the per-frame
    StorageLogDetailedState (forward queue length/tail + pending-rollback
    segment) at every frame boundary.

These witnesses are the oracle-side half of the MainVM far-call argument:
each push/pop carries (cycle, depth, entry encoding, state_before,
state_after), ready to feed a far-call stack accumulator the way near-call
rows consume frame_pops today.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..ops.poseidon2_params import RATE, T
from . import encodings as enc
from .queues import QueueSimulator

P = gl.P


class _EntryView:
    """Adapter: vm.state.CallstackEntry -> the attribute surface
    encode_extended_callstack_entry expects (callstack_entry.rs field
    names; shard ids are 0 in the single-shard VM)."""

    def __init__(self, frame):
        self.code_address = int(frame.code_address)
        self.this_address = int(frame.this_address)
        self.msg_sender = int(frame.msg_sender)
        self.context_u128_value = int(getattr(frame, "context_u128", 0))
        self.code_page = int(frame.code_page)
        self.pc = int(frame.pc)
        self.this_shard_id = 0
        self.is_static = bool(getattr(frame, "is_static", False))
        self.base_memory_page = int(frame.base_memory_page)
        self.sp = int(getattr(frame, "sp", 0))
        self.caller_shard_id = 0
        self.is_kernel_mode = bool(getattr(frame, "is_kernel_mode", False))
        self.ergs_remaining = int(frame.ergs_remaining)
        self.exception_handler_location = int(
            getattr(frame, "exception_handler", 0))
        self.code_shard_id = 0
        self.is_local_frame = bool(getattr(frame, "is_local_call", False))
        self.heap_bound = int(getattr(frame, "heap_bound", 0))
        self.aux_heap_bound = int(getattr(frame, "aux_heap_bound", 0))


def _absorb_full_width(state: Sequence[int], row: Sequence[int],
                       device) -> List[int]:
    """Overwrite-absorb a width-32 encoding in rate-8 chunks (the same
    chunked sponge rule the full-width queue simulator uses)."""
    st = gl.from_int(np.array(list(state), dtype=object), device)
    row = [int(v) % P for v in row]
    assert len(row) % RATE == 0
    chunks = gl.from_int(np.array(row, dtype=object), device).reshape(
        -1, RATE)
    st = p2.absorb_chunks(st, chunks)
    return [int(v) for v in gl.to_ints(st)]


@dataclasses.dataclass
class StackOpWitness:
    cycle: int
    is_push: bool
    depth_before: int
    encoding: List[int]          # width-32 extended callstack entry
    state_before: Tuple[int, ...]
    state_after: Tuple[int, ...]


class FullWidthStackSimulator:
    """Sponge stack over 12-lane states. Push: state' = absorb(state, enc).
    Pop: restore the recorded pre-push state (the witness the in-circuit
    argument re-hashes)."""

    def __init__(self, device=None):
        self.device = gl.resolve_device(device)
        self.state: Tuple[int, ...] = (0,) * T
        self._saved: List[Tuple[Tuple[int, ...], List[int]]] = []
        self.witnesses: List[StackOpWitness] = []

    @property
    def depth(self) -> int:
        return len(self._saved)

    def push(self, cycle: int, encoding: Sequence[int]):
        before = self.state
        after = tuple(_absorb_full_width(before, encoding, self.device))
        self._saved.append((before, [int(v) % P for v in encoding]))
        self.witnesses.append(StackOpWitness(
            cycle=cycle, is_push=True, depth_before=len(self._saved) - 1,
            encoding=[int(v) % P for v in encoding],
            state_before=before, state_after=after))
        self.state = after

    def pop(self, cycle: int) -> List[int]:
        assert self._saved, "pop from empty callstack"
        before = self.state
        prev_state, encoding = self._saved.pop()
        # soundness hook: the recorded relation absorb(prev, enc) == before
        assert tuple(_absorb_full_width(prev_state, encoding,
                                        self.device)) == before, \
            "stack sponge relation broken"
        self.witnesses.append(StackOpWitness(
            cycle=cycle, is_push=False, depth_before=len(self._saved) + 1,
            encoding=list(encoding), state_before=before,
            state_after=prev_state))
        self.state = prev_state
        return encoding


@dataclasses.dataclass
class StorageLogDetailedState:
    """oracle.rs StorageLogDetailedState: the log-queue view at a frame
    boundary — forward segment state + pending rollback segment."""
    forward_length: int
    forward_tail: Tuple[int, ...]     # narrow 4-lane tail
    rollback_length: int              # pending rollbacks in scope


@dataclasses.dataclass
class FrameLogBoundary:
    cycle: int
    is_push: bool
    depth: int
    state: StorageLogDetailedState


@dataclasses.dataclass
class CallstackSimResult:
    ops: List[StackOpWitness]
    log_boundaries: List[FrameLogBoundary]
    final_state: Tuple[int, ...]
    max_depth: int


def simulate_callstack(tracer, device=None) -> CallstackSimResult:
    """Replay the traced context pushes/pops through the sponge stack and
    reconstruct per-boundary StorageLogDetailedState.

    Uses tracer.context_pushes / context_pops (cycle-ordered); the forward
    log tail at a boundary is the narrow log-queue simulator state over all
    forward entries recorded up to that cycle (the same chain
    oracle.create_artifacts_from_tracer commits to)."""
    pushes = list(getattr(tracer, "context_pushes", []))
    pops = list(getattr(tracer, "context_pops", []))
    events: List[Tuple[int, int, str, object]] = []
    for i, (cycle, frame) in enumerate(pushes):
        events.append((cycle, 0, "push", frame))
    for i, (cycle, frame, panicked) in enumerate(pops):
        events.append((cycle, 1, "pop", (frame, panicked)))
    events.sort(key=lambda e: (e[0], e[1]))

    # forward log chain (narrow 20-wide queue as the oracle uses) with a
    # cycle -> (length, tail) map
    fwd = list(tracer.callstack_with_aux_data.forward)
    q = QueueSimulator(width=20, device=device)
    for _c, lq in fwd:
        q.push(enc.encode_log_query(lq))
    tails = q.tails()

    def forward_state_at(cycle: int) -> Tuple[int, Tuple[int, ...]]:
        n = 0
        for c, _lq in fwd:
            if c > cycle:
                break
            n += 1
        return n, tuple(int(v) for v in tails[n])

    # pending-rollback count per cycle: +1 per rw forward log (non-rollback),
    # -frame's worth on pop (replayed or donated — donation keeps them
    # pending in the parent, replay moves them to forward)
    sim = FullWidthStackSimulator(device)
    boundaries: List[FrameLogBoundary] = []
    max_depth = 0
    pending_stack: List[int] = [0]
    rw_by_cycle: Dict[int, int] = {}
    for c, lq in fwd:
        if lq.rw_flag and not lq.rollback:
            rw_by_cycle[c] = rw_by_cycle.get(c, 0) + 1
    cursor = 0
    cycles_sorted = sorted(rw_by_cycle)

    def pending_until(cycle: int):
        nonlocal cursor
        while cursor < len(cycles_sorted) and cycles_sorted[cursor] <= cycle:
            pending_stack[-1] += rw_by_cycle[cycles_sorted[cursor]]
            cursor += 1

    for cycle, _k, kind, payload in events:
        pending_until(cycle)
        if kind == "push":
            frame = payload
            n_fwd, tail = forward_state_at(cycle)
            rollback_len = sum(pending_stack)
            boundaries.append(FrameLogBoundary(
                cycle=cycle, is_push=True, depth=sim.depth,
                state=StorageLogDetailedState(n_fwd, tail[:4],
                                              rollback_len)))
            encoding = enc.encode_extended_callstack_entry(
                _EntryView(frame), rollback_queue_head=(0, 0, 0, 0),
                rollback_queue_tail=tuple(tail[:4]),
                rollback_queue_segment_length=rollback_len)
            sim.push(cycle, encoding)
            pending_stack.append(0)
            max_depth = max(max_depth, sim.depth)
        else:
            _frame, panicked = payload
            frame_pending = pending_stack.pop()
            if panicked:
                pass  # replayed into forward (merge-on-pop panic path)
            else:
                pending_stack[-1] += frame_pending  # donated to parent
            sim.pop(cycle)
            n_fwd, tail = forward_state_at(cycle)
            boundaries.append(FrameLogBoundary(
                cycle=cycle, is_push=False, depth=sim.depth,
                state=StorageLogDetailedState(n_fwd, tail[:4],
                                              sum(pending_stack))))
    assert sim.depth == 0, "unbalanced callstack at block exit"
    assert sim.state == (0,) * T, "stack sponge did not return to its seed"
    return CallstackSimResult(ops=sim.witnesses, log_boundaries=boundaries,
                              final_state=sim.state, max_depth=max_depth)
