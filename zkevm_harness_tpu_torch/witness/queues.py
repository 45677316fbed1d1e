"""Poseidon2 queue simulators + permutation-argument kernels (PyTorch).

Counterpart of the JAX package's `witness/queues.py` (the reference's
`circuit_encodings` crate, circuit_encodings/src/lib.rs:23-787, and the
grand-product chains of src/witness/utils.rs:498-620): out-of-circuit queue
simulators whose running sponge tails mirror the in-circuit queue hashing,
used by every witness decomposer.

Two simulator flavors, exactly as in the reference:

  - `QueueSimulator` (narrow, lib.rs:92-304): 4-element head/tail
    commitments. Each push hashes [encoding || old_tail] from a FRESH zero
    state with overwrite-mode absorption in rate-8 chunks (one Poseidon2
    permutation per chunk), then reads the first 4 lanes as the new tail.
    Log queries (width 20 -> 24 = 3 rounds) ride this flavor.
  - `FullWidthQueueSimulator` (lib.rs:322-507): the sponge state itself (12
    lanes) is the head/tail. Each push overwrite-absorbs the encoding into
    the rate lanes of the CURRENT tail state and permutes. Memory /
    decommittment / recursion queues (width 8 = 1 round) ride this flavor.

Where each function runs:
  - the tail and state chains (`simulate_tails`, `simulate_states_full`) are
    serial sponges, a `lax.scan` in JAX: here a host loop of overwrite
    absorbs, each one launch of the Poseidon2 kernel over the batch of
    queues (one state for a single queue);
  - `grand_product_chain` is a log-depth inclusive prefix product on the
    device (doubling over the field-multiply kernel);
  - `sort_by_u64_keys` is `torch.sort(stable=True)` on the device, over one
    int64 per key with its sign bit flipped, so that signed order is the
    unsigned order of the u64 bit pattern (the keys already lie on the
    device in the port's layout; the host would need a copy there and back);
  - `fs_challenge_terms` is one broadcast multiply and a log-depth sum.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..ops.goldilocks import GF, P
from ..ops.poseidon2_params import RATE, T

TAIL_WIDTH = 4                      # QUEUE_STATE_WIDTH
FULL_STATE_WIDTH = 12               # FULL_SPONGE_QUEUE_STATE_WIDTH
LOG_QUERY_PACKED_WIDTH = 20
MEMORY_QUERY_PACKED_WIDTH = 8
_SIGN = -(1 << 63)                  # int64 with only the sign bit set


def _absorb_rounds(state: GF, values: GF) -> GF:
    """Overwrite-mode absorption of (..., k*RATE) values: per chunk, set the
    rate lanes and permute (boojum absorb_multiple_rounds with
    AbsorptionModeOverwrite)."""
    k = values.shape[-1]
    assert k % RATE == 0
    for i in range(k // RATE):
        state = p2.full_width_absorb(state,
                                     values[..., i * RATE:(i + 1) * RATE])
    return state


def simulate_tails(encodings: GF, initial_tail: GF) -> GF:
    """Narrow-queue chain: tails[i+1] = P2_absorb(zeros, enc_i || tails[i])[:4].

    encodings: (..., n, W) with (W + 4) % 8 == 0 (callers pad otherwise);
    initial_tail: (..., 4). Returns tails: (..., n+1, 4), tails[0] = initial.
    Mirrors QueueSimulator::push (circuit_encodings/src/lib.rs:179-221).
    """
    n = encodings.shape[-2]
    batch = encodings.shape[:-2]
    tail = initial_tail
    out = [tail]
    for i in range(n):
        to_hash = torch.cat([encodings[..., i, :], tail], dim=-1)
        state = torch.zeros(batch + (T,), dtype=torch.int64,
                            device=encodings.device)
        tail = _absorb_rounds(state, to_hash)[..., :TAIL_WIDTH]
        out.append(tail)
    return torch.stack(out, dim=-2)


def simulate_states_full(encodings: GF, initial_state: GF) -> GF:
    """Full-width chain: state[i+1] = P2(overwrite(state[i], enc_i)).

    encodings: (..., n, W) with W % 8 == 0; initial_state: (..., 12).
    Returns states: (..., n+1, 12). Mirrors FullWidthQueueSimulator::push
    (circuit_encodings/src/lib.rs:391-429).
    """
    state = initial_state
    out = [state]
    for i in range(encodings.shape[-2]):
        state = _absorb_rounds(state, encodings[..., i, :])
        out.append(state)
    return torch.stack(out, dim=-2)


@dataclasses.dataclass
class QueueState:
    """Observable queue state (head/tail commitments + length), as exact ints.

    Mirrors the closed-form-input queue states of the reference (narrow: 4
    elements; full-width: 12 elements)."""

    head: Tuple[int, ...] = (0, 0, 0, 0)
    tail: Tuple[int, ...] = (0, 0, 0, 0)
    length: int = 0


class _SimulatorBase:
    """Shared push/split/merge plumbing; subclasses define the tail chain.

    The chain runs on `device` (`None` means the CUDA card and raises where
    there is none) the first time the tails are read."""

    STATE_WIDTH = TAIL_WIDTH

    def __init__(self, encodings: Optional[np.ndarray] = None,
                 head: Optional[Tuple[int, ...]] = None,
                 width: int = MEMORY_QUERY_PACKED_WIDTH, device=None):
        self.width = int(width)
        self.device = gl.resolve_device(device)
        self.encodings = (np.zeros((0, self.width), dtype=object)
                          if encodings is None else encodings)
        assert self.encodings.shape[1] == self.width
        self.head = tuple(head) if head is not None else (0,) * self.STATE_WIDTH
        assert len(self.head) == self.STATE_WIDTH
        self._tails: Optional[np.ndarray] = None  # (n+1, STATE_WIDTH) cache

    def __len__(self):
        return self.encodings.shape[0]

    def push(self, encoding):
        enc = np.array([[int(v) % P for v in encoding]], dtype=object)
        assert enc.shape[1] == self.width
        self.encodings = np.concatenate([self.encodings, enc], axis=0)
        self._tails = None

    def push_many(self, encodings):
        enc = np.array([[int(v) % P for v in row] for row in encodings],
                       dtype=object)
        if len(enc) == 0:
            return
        self.encodings = np.concatenate(
            [self.encodings, enc.reshape(-1, self.width)], axis=0)
        self._tails = None

    def _run_chain(self) -> np.ndarray:
        raise NotImplementedError

    def tails(self) -> np.ndarray:
        """(n+1, STATE_WIDTH) int array of states (tails[0] = head state)."""
        if self._tails is None:
            if len(self) == 0:
                self._tails = np.array([list(self.head)], dtype=object)
            else:
                self._tails = self._run_chain()
        return self._tails

    def states(self) -> np.ndarray:
        return self.tails()

    @property
    def tail(self) -> Tuple[int, ...]:
        return tuple(int(v) for v in self.tails()[-1])

    def state(self) -> QueueState:
        return QueueState(head=self.head, tail=self.tail, length=len(self))

    def split_by(self, chunk: int) -> List["_SimulatorBase"]:
        """Split into chunks of `chunk` items; chunk i's head is the parent's
        tail after i*chunk items (circuit_encodings/src/lib.rs:268-307)."""
        tails = self.tails()
        out = []
        for start in range(0, max(len(self), 1), chunk):
            sub = type(self)(self.encodings[start:start + chunk],
                             head=tuple(int(v) for v in tails[start]),
                             width=self.width, device=self.device)
            sub._tails = tails[start:start + min(chunk, len(self) - start) + 1]
            out.append(sub)
        return out

    @classmethod
    def merge(cls, a: "_SimulatorBase", b: "_SimulatorBase") -> "_SimulatorBase":
        """Concatenate; requires b.head == a.tail (lib.rs:152-165)."""
        assert tuple(b.head) == tuple(a.tail), "queue continuity broken"
        assert a.width == b.width
        return cls(np.concatenate([a.encodings, b.encodings], axis=0),
                   head=a.head, width=a.width, device=a.device)


class QueueSimulator(_SimulatorBase):
    """Narrow queue (4-element tail commitments) — log-query flavor.

    API parity with the reference's `QueueSimulator` (push, split_by, merge —
    circuit_encodings/src/lib.rs:92-304). The tail step hashes
    [encoding || old_tail] from a fresh zero state; encodings whose
    (width + 4) is not a rate multiple are zero-padded up to one (all
    reference widths divide exactly: 20 + 4 = 24)."""

    STATE_WIDTH = TAIL_WIDTH

    def __init__(self, encodings: Optional[np.ndarray] = None,
                 head: Optional[Tuple[int, ...]] = None,
                 width: int = LOG_QUERY_PACKED_WIDTH, device=None):
        super().__init__(encodings, head, width, device)

    def _run_chain(self) -> np.ndarray:
        enc = self.encodings
        pad = (-(self.width + TAIL_WIDTH)) % RATE
        if pad:
            # pad the ENCODING so [enc || pad || tail] fills whole rate chunks
            z = np.zeros((enc.shape[0], pad), dtype=object)
            enc = np.concatenate([enc, z], axis=1)
        out = simulate_tails(
            gl.from_int(enc, self.device),
            gl.from_int(np.array(list(self.head), dtype=object), self.device))
        return gl.to_ints(out)


class FullWidthQueueSimulator(_SimulatorBase):
    """Full-width queue (12-element sponge-state tails) — memory/decommit/
    recursion flavor (circuit_encodings/src/lib.rs:322-507)."""

    STATE_WIDTH = FULL_STATE_WIDTH

    def __init__(self, encodings: Optional[np.ndarray] = None,
                 head: Optional[Tuple[int, ...]] = None,
                 width: int = MEMORY_QUERY_PACKED_WIDTH, device=None):
        assert width % RATE == 0
        super().__init__(encodings, head, width, device)

    def _run_chain(self) -> np.ndarray:
        out = simulate_states_full(
            gl.from_int(self.encodings, self.device),
            gl.from_int(np.array(list(self.head), dtype=object), self.device))
        return gl.to_ints(out)


# ---------------------------------------------------------------------------
# Permutation argument kernels
# ---------------------------------------------------------------------------

def grand_product_chain(terms: GF) -> GF:
    """Inclusive prefix products over the last axis (log-depth).

    Replaces compute_grand_product_chains (src/witness/utils.rs:552+). The
    final element is the grand product; intermediate values feed per-circuit
    FSM continuation witnesses. After the step of distance d, entry i holds
    the product of entries (i - 2d, i]; field multiplication is exact, so the
    result equals any other order of the same products.
    """
    n = terms.shape[-1]
    x = terms
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], gl.mul(x[..., d:], x[..., :n - d])],
                      dim=-1)
        d *= 2
    return x


def sort_by_u64_keys(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                     values: GF):
    """Stable sort of GF values by a (hi, lo) 32-bit-pair 64-bit key.

    Replaces rayon par_sort in the memory-queue sorter
    (ram_permutation.rs:50 — sort by (location, timestamp)). keys_hi and
    keys_lo are int64 tensors of values below 2^32; the pair is one u64 bit
    pattern hi << 32 | lo, sorted as signed int64 once its sign bit is
    flipped. Returns (sorted_hi, sorted_lo, sorted_values,
    permutation_idx).
    """
    key = ((keys_hi << 32) | keys_lo) ^ _SIGN
    _, idx = torch.sort(key, stable=True)
    return keys_hi[idx], keys_lo[idx], values[idx], idx


def fs_challenge_terms(tuples: GF, challenges: GF, gamma: GF) -> GF:
    """Linear-combination terms for a grand-product permutation argument:
    term_i = gamma + sum_j challenges[j] * tuples[i, j]
    (produce_fs_challenges, src/witness/utils.rs:498-550).

    tuples: (n, k); challenges: (k,); gamma: scalar. Returns (n,).
    """
    prods = gl.mul(tuples, challenges[None, :])
    return gl.add(gl.sum_axis(prods, axis=-1), gamma)
