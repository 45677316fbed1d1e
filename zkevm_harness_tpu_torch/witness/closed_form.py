"""Real closed-form inputs per base-circuit instance.

Counterpart of the JAX package's `witness/closed_form.py` (host ints only).

Parity with the reference's per-instance ClosedFormInput content
(src/witness/postprocessing/mod.rs:136-294): observable input (values
shared by every instance of the type — the Fiat-Shamir challenges),
observable output, and the hidden FSM input/output that CHAINS a split
argument across instances (queue-state capacity lanes, permutation
accumulators, item counters, sorted-entry carry, MainVM snapshot state).

Every value here is REAL: it is read off the decomposer's instance witness
and appears verbatim in the instance's proven public-input vector
(prover/layers.real_base_instance_public_inputs), so the CircuitMaker's
FSM-continuation assertion (postprocessing.py) is a genuine cross-instance
chain check, and the recursion-queue digests commit to exactly the values
the leaf circuits re-verify in-circuit.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import goldilocks as gl
from .postprocessing import ClosedFormInput

P = gl.P


def _caps(state) -> List[int]:
    """Capacity lanes of a queue head/tail (the only lanes that chain)."""
    return [int(v) % P for v in list(state)[8:12]]


def _flat(vals) -> List[int]:
    out: List[int] = []
    for v in vals:
        if isinstance(v, (tuple, list)):
            out.extend(int(x) % P for x in v)
        else:
            out.append(int(v) % P)
    return out


def _enc_or(enc, fallback: Sequence[int], width: int = 8) -> List[int]:
    if enc is None:
        return list(fallback)[:width] if fallback else [0] * width
    return [int(v) % P for v in list(enc)[:width]]


def build_closed_form(ctype: int, inst_w, challenges, is_first: bool,
                      is_last: bool) -> ClosedFormInput:
    """CFI for one instance of `ctype` from its decomposer witness."""
    t = int(ctype)
    if t == 1:  # MainVM: snapshot FSM (oracle.rs:1164-1420 role)
        first = inst_w.rows[0] if inst_w.rows else None
        pc_in = first.pc if first else inst_w.exit_pc
        ts_in = first.ts if first else inst_w.exit_ts
        fl_in = first.flags if first else inst_w.exit_flags
        regs_in = first.regs if first else inst_w.exit_regs
        obs_in = _flat([inst_w.challenge, inst_w.gamma_code,
                        inst_w.gamma_log, inst_w.gamma_mem,
                        inst_w.gamma_stack])
        fsm_in = _flat([inst_w.acc_in, inst_w.depth_in, pc_in, ts_in,
                        1 if fl_in[0] else 0, 1 if fl_in[1] else 0,
                        [r % P for r in regs_in]])
        fsm_out = _flat([inst_w.acc_out, inst_w.depth_out, inst_w.exit_pc,
                         inst_w.exit_ts,
                         1 if inst_w.exit_flags[0] else 0,
                         1 if inst_w.exit_flags[1] else 0,
                         [r % P for r in inst_w.exit_regs]])
        return ClosedFormInput(is_first, is_last, tuple(obs_in), (),
                               tuple(fsm_in), tuple(fsm_out))

    if t == 8:  # RAM permutation: 2 queues + 2x2 accumulators + sorted carry
        last_sorted = (inst_w.sorted_encodings[-1]
                       if len(inst_w.sorted_encodings) else None)
        fsm_in = (_caps(inst_w.unsorted_queue_state[0])
                  + _caps(inst_w.sorted_queue_state[0])
                  + _flat([inst_w.accumulators_in, inst_w.num_items_in])
                  + _enc_or(inst_w.prev_sorted_entry, []))
        fsm_out = (_caps(inst_w.unsorted_queue_state[1])
                   + _caps(inst_w.sorted_queue_state[1])
                   + _flat([inst_w.accumulators_out,
                            inst_w.num_items_in + inst_w.num_items])
                   + _enc_or(last_sorted, _enc_or(inst_w.prev_sorted_entry,
                                                  [])))
        obs_out = _flat([inst_w.unsorted_queue_state[1],
                         inst_w.sorted_queue_state[1]])
        return ClosedFormInput(is_first, is_last,
                               tuple(_flat(challenges)), tuple(obs_out),
                               tuple(fsm_in), tuple(fsm_out))

    if t == 2:  # decommit-requests sorter: 3 queues + carry
        last_sorted = (inst_w.sorted_encodings[-1]
                       if len(inst_w.sorted_encodings) else None)
        fsm_in = (_caps(inst_w.unsorted_queue_state[0])
                  + _caps(inst_w.sorted_queue_state[0])
                  + _caps(inst_w.output_queue_state[0])
                  + _flat([inst_w.accumulators_in, inst_w.num_items_in,
                           inst_w.out_items_in])
                  + _enc_or(inst_w.prev_sorted_entry, []))
        fsm_out = (_caps(inst_w.unsorted_queue_state[1])
                   + _caps(inst_w.sorted_queue_state[1])
                   + _caps(inst_w.output_queue_state[1])
                   + _flat([inst_w.accumulators_out,
                            inst_w.num_items_in + inst_w.num_items,
                            inst_w.out_items_in + inst_w.out_items])
                   + _enc_or(last_sorted, _enc_or(inst_w.prev_sorted_entry,
                                                  [])))
        obs_out = _flat([inst_w.output_queue_state[1]])
        return ClosedFormInput(is_first, is_last,
                               tuple(_flat(challenges)), tuple(obs_out),
                               tuple(fsm_in), tuple(fsm_out))

    if t in (9, 11, 12):  # storage/events/l1-messages sorters
        enc_w = 20
        prev = getattr(inst_w, "prev_enc", None)
        if prev is None and hasattr(inst_w, "prev_ts"):
            prev = None  # events chain on prev_ts below
        last_sorted = (inst_w.sorted_encodings[-1]
                       if len(inst_w.sorted_encodings) else None)
        carry_in: List[int]
        carry_out: List[int]
        if hasattr(inst_w, "prev_enc"):
            carry_in = _enc_or(inst_w.prev_enc, [], enc_w)
            carry_out = _enc_or(last_sorted, carry_in, enc_w)
        else:  # events: timestamp carry
            carry_in = [int(inst_w.prev_ts)]
            from .sorters import _event_ts
            carry_out = ([int(_event_ts(last_sorted))]
                         if last_sorted is not None else carry_in)
        fsm_in = (_caps(inst_w.input_queue_state[0])
                  + _caps(inst_w.sorted_queue_state[0])
                  + _caps(inst_w.output_queue_state[0])
                  + _flat([inst_w.accumulators_in, inst_w.num_items_in,
                           inst_w.out_items_in])
                  + carry_in)
        fsm_out = (_caps(inst_w.input_queue_state[1])
                   + _caps(inst_w.sorted_queue_state[1])
                   + _caps(inst_w.output_queue_state[1])
                   + _flat([inst_w.accumulators_out,
                            inst_w.num_items_in + inst_w.num_items,
                            inst_w.out_items_in + inst_w.out_items])
                   + carry_out)
        obs_out = _flat([inst_w.output_queue_state[1]])
        return ClosedFormInput(is_first, is_last,
                               tuple(_flat(challenges)), tuple(obs_out),
                               tuple(fsm_in), tuple(fsm_out))

    if t == 4:  # log demuxer: 1 input + 6 output queues
        fsm_in = (_caps(inst_w.input_queue_state[0])
                  + sum((_caps(s[0]) for s in inst_w.output_queue_states),
                        [])
                  + _flat([inst_w.num_items_in, inst_w.out_items_in]))
        fsm_out = (_caps(inst_w.input_queue_state[1])
                   + sum((_caps(s[1]) for s in inst_w.output_queue_states),
                         [])
                   + _flat([inst_w.num_items_in + inst_w.num_items,
                            [i + o for i, o in zip(inst_w.out_items_in,
                                                   inst_w.out_items)]]))
        obs_out = _flat([s[1] for s in inst_w.output_queue_states])
        return ClosedFormInput(is_first, is_last, (), tuple(obs_out),
                               tuple(fsm_in), tuple(fsm_out))

    if t in (5, 6):  # precompile round functions: accumulator + counter FSM
        fsm_in = _flat([inst_w.acc_in, inst_w.cnt_in])
        fsm_out = _flat([inst_w.acc_out, inst_w.cnt_out])
        ch, gm = challenges
        return ClosedFormInput(is_first, is_last,
                               tuple(_flat([ch, gm])), (),
                               tuple(fsm_in), tuple(fsm_out))

    if t == 3:  # code decommitter: per-bytecode sha256 chain (one shot)
        return ClosedFormInput(is_first, is_last, (), (), (), ())

    if t == 13:  # L1-messages linear hasher: one keccak chain per block
        return ClosedFormInput(is_first, is_last, (), (), (), ())

    if t == 7:  # ecrecover: independent invocations, no FSM
        inv = inst_w.invocations[0]
        obs_out = _flat([inv.r % P, inv.s % P,
                         int.from_bytes(inv.msg_hash, "big") % P])
        return ClosedFormInput(is_first, is_last, (), tuple(obs_out), (), ())

    if t == 10:  # storage application: one Merkle PATH per instance
        # (read/write flattened for the tower); the queue digest binds the
        # full PI vector incl. leaf/path/root bits, so root chaining is
        # pinned by the recursion queue contents
        return ClosedFormInput(is_first, is_last, (), (), (), ())

    raise KeyError(ctype)
