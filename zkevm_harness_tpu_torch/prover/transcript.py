"""Fiat-Shamir transcript over a Poseidon2 sponge (PyTorch).

Counterpart of the JAX package's `prover/transcript.py`: absorb commitments
and evaluations as Goldilocks elements, squeeze base/extension challenges and
query indices. The state is one (12,) field tensor on `device`; every
permutation goes through `ops.poseidon2.permute` (the CUDA kernel on the
card), everything else is host bookkeeping.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import poseidon2 as p2
from ..ops.poseidon2_params import RATE, T


class Transcript:
    def __init__(self, domain_tag: int = 0, device=None):
        self.device = gl.resolve_device(device)
        state = np.zeros(T, dtype=object)
        state[T - 1] = domain_tag % gl.P
        self._state = gl.from_int(state, self.device)
        self._buffer: List[int] = []
        # squeeze window: lanes [0, RATE) of the current state; _sq_idx is
        # the next unread lane (RATE = exhausted/invalidated), _sq_host the
        # lazily-fetched host ints of the window
        self._sq_idx = RATE
        self._sq_host = None
        # duplex semantics: reading challenges does NOT advance the state; a
        # permutation happens lazily only when more than RATE challenges are
        # drawn from one state. Each absorb block's output lanes ARE the
        # challenges drawn at that point, and the next absorption overwrites
        # the rate lanes.
        self._read_since_permute = False

    # -- absorbing ---------------------------------------------------------

    def _invalidate_squeeze(self):
        self._sq_idx = RATE
        self._sq_host = None
        self._read_since_permute = False

    def absorb_ints(self, values: Sequence[int]):
        self._invalidate_squeeze()
        self._buffer.extend(int(v) % gl.P for v in values)
        n_chunks = len(self._buffer) // RATE
        if n_chunks == 0:
            return
        flat = self._buffer[:n_chunks * RATE]
        self._buffer = self._buffer[n_chunks * RATE:]
        chunks = gl.from_int(np.array(flat, dtype=object), self.device)
        self._state = p2.absorb_chunks(self._state,
                                       chunks.reshape(n_chunks, RATE))

    def absorb_gf(self, values: gl.GF):
        self.absorb_ints([int(v) for v in gl.to_ints(values).ravel()])

    def absorb_gf_device(self, values: gl.GF):
        """Absorb device-resident field elements; leaves exactly the state
        absorb_ints of the same values would: pending buffered ints are
        prepended, full rate-chunks are permuted, and the sub-chunk remainder
        is fetched (tiny) into the int buffer."""
        self._invalidate_squeeze()
        flat = values.reshape(-1).to(self.device)
        if self._buffer:
            pre = gl.from_int(np.array(self._buffer, dtype=object),
                              self.device)
            self._buffer = []
            flat = torch.cat([pre, flat])
        k = flat.shape[0]
        n_full = k // RATE
        if n_full:
            self._state = p2.absorb_chunks(
                self._state, flat[:n_full * RATE].reshape(n_full, RATE))
        if k - n_full * RATE:
            self._buffer.extend(int(v) for v in
                                gl.to_u64(flat[n_full * RATE:]))

    def absorb_ext(self, value: gl.GF2):
        self.absorb_ints([int(gl.to_ints(value.c0)),
                          int(gl.to_ints(value.c1))])

    def _flush(self):
        if self._buffer:
            chunk = self._buffer + [0] * (RATE - len(self._buffer))
            self._buffer = []
            enc = gl.from_int(np.array(chunk, dtype=object), self.device)
            self._state = p2.permute(p2._overwrite(self._state, enc, 0))

    # -- squeezing ---------------------------------------------------------

    def _refill(self):
        self._flush()
        if self._read_since_permute:
            # drawing more than RATE challenges from one state: advance
            self._state = p2.permute(self._state)
        self._sq_idx = 0
        self._sq_host = None
        self._read_since_permute = True

    def _squeeze_one(self) -> int:
        if self._sq_idx >= RATE:
            self._refill()
        if self._sq_host is None:
            self._sq_host = [int(v) for v in gl.to_u64(self._state)[:RATE]]
        v = self._sq_host[self._sq_idx]
        self._sq_idx += 1
        return v

    def _squeeze_one_dev(self) -> gl.GF:
        """Squeeze one lane as a 0-d tensor on the transcript's device (no
        host fetch). Same state evolution as _squeeze_one."""
        if self._sq_idx >= RATE:
            self._refill()
        i = self._sq_idx
        self._sq_idx += 1
        return self._state[i]

    def challenge_base(self) -> int:
        return self._squeeze_one()

    def challenge_ext(self) -> gl.GF2:
        """Extension challenge as device scalars."""
        c0 = self._squeeze_one_dev()
        c1 = self._squeeze_one_dev()
        return gl.GF2(c0, c1)

    def challenge_ext_ints(self):
        return self._squeeze_one(), self._squeeze_one()

    def query_indices(self, count: int, domain_size: int) -> np.ndarray:
        """`count` indices in [0, domain_size); domain_size a power of two.
        Exactly the _squeeze_one chain."""
        mask = domain_size - 1
        assert domain_size & mask == 0
        out = np.empty(count, dtype=np.uint32)
        for i in range(count):
            out[i] = self._squeeze_one() & mask
        return out
