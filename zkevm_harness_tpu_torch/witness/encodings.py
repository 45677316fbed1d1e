"""Bit-exact per-type queue encodings (the `circuit_encodings` packings).

Re-implements the reference's out-of-circuit fixed-length encodings exactly:
  - memory queries  (circuit_encodings/src/memory_query.rs:24-117, width 8)
  - log queries     (circuit_encodings/src/log_query.rs:102-395, width 20)
  - timestamped log queries (log_query.rs:400-427)
  - decommittment requests (circuit_encodings/src/decommittment_request.rs:6-73,
    width 8)
  - recursion requests (circuit_encodings/src/recursion_request.rs:13-28,
    width 8)
  - extended callstack entries (circuit_encodings/src/callstack_entry.rs:34-178,
    width 32)
  - L2->L1 message byte serialization (log_query.rs:503-534, 88 bytes)
  - state-diff record byte encoding (circuit_encodings/src/state_diff_record.rs:19-53,
    156 bytes)
plus the sorting/comparison keys used by the sorter circuits.

Every packed limb is < 2^56 < p (the reference asserts F::CAPACITY_BITS >= 56)
and the packing is injective: each input bit lands in exactly one limb at a
fixed offset, so distinct queries can never collide — the soundness
precondition for every permutation/queue argument built on these encodings.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..vm.environment import DecommittmentQuery, LogQuery, MemoryQuery

MEMORY_QUERY_PACKED_WIDTH = 8
LOG_QUERY_PACKED_WIDTH = 20
DECOMMIT_QUERY_PACKED_WIDTH = 8
RECURSION_QUERY_PACKED_WIDTH = 8
EXECUTION_CONTEXT_RECORD_ENCODING_WIDTH = 32
L2_TO_L1_MESSAGE_BYTE_LENGTH = 88
STATE_DIFF_RECORD_BYTE_ENCODING_LEN = 156

# TimestampedStorageLogRecord packing constants (zkevm_circuits
# storage_validity_by_grand_product: the extended enumeration timestamp is
# mixed into the rollback-flag limb at bit offset 8).
EXTENDED_TIMESTAMP_ENCODING_ELEMENT = 19
EXTENDED_TIMESTAMP_ENCODING_OFFSET = 8

_M32 = (1 << 32) - 1


def _u256_as_u32x8(v: int) -> List[int]:
    """decompose_u256_as_u32x8: little-endian u32 words."""
    return [(v >> (32 * i)) & _M32 for i in range(8)]


def _address_as_u32x5(addr: int) -> List[int]:
    """decompose_address_as_u32x5: 160-bit address, little-endian u32 words."""
    return [(addr >> (32 * i)) & _M32 for i in range(5)]


def _le_bytes(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "little")


def encode_memory_query(q: MemoryQuery) -> List[int]:
    """memory_query.rs:24-117: 3 limbs for ts/page/index+flags, 5 limbs
    packing the 8 value words tightly (words 5-7 byte-sliced into the high
    bits of limbs 3-6)."""
    w = _u256_as_u32x8(q.value)
    d5 = _le_bytes(w[5], 4)
    d6 = _le_bytes(w[6], 4)
    d7 = _le_bytes(w[7], 4)
    v0 = q.timestamp & _M32
    v1 = q.location.page & _M32
    v2 = ((q.location.index & _M32)
          | ((1 if q.rw_flag else 0) << 32)
          | ((1 if q.value_is_pointer else 0) << 33))
    v3 = w[0] | (d5[0] << 32) | (d5[1] << 40) | (d5[2] << 48)
    v4 = w[1] | (d5[3] << 32) | (d6[0] << 40) | (d6[1] << 48)
    v5 = w[2] | (d6[2] << 32) | (d6[3] << 40) | (d7[0] << 48)
    v6 = w[3] | (d7[1] << 32) | (d7[2] << 40) | (d7[3] << 48)
    v7 = w[4]
    return [v0, v1, v2, v3, v4, v5, v6, v7]


def memory_sorting_key(q: MemoryQuery) -> int:
    """(timestamp, index, page) little-endian words -> one comparable int
    (memory_query.rs:6-14: page is most significant)."""
    return ((q.location.page & _M32) << 64) | ((q.location.index & _M32) << 32) \
        | (q.timestamp & _M32)


def memory_comparison_key(q: MemoryQuery) -> int:
    """(index, page) LE words (memory_query.rs:16-20)."""
    return ((q.location.page & _M32) << 32) | (q.location.index & _M32)


def encode_log_query(q: LogQuery) -> List[int]:
    """log_query.rs:102-395: read/written value words carry key and address
    bytes in their high bits; ts/tx/aux/shard/flags fill the tail limbs."""
    kb = _le_bytes(q.key, 32)                 # key little-endian bytes
    ab = _le_bytes(q.address, 20)             # address LE bytes (BE reversed)
    rv = _u256_as_u32x8(q.read_value)
    wv = _u256_as_u32x8(q.written_value)
    out: List[int] = []
    # v0..v7: read-value words + key bytes 0..23
    for i in range(8):
        out.append(rv[i] | (kb[3 * i] << 32) | (kb[3 * i + 1] << 40)
                   | (kb[3 * i + 2] << 48))
    # v8..v9: written-value words 0..1 + key bytes 24..29
    out.append(wv[0] | (kb[24] << 32) | (kb[25] << 40) | (kb[26] << 48))
    out.append(wv[1] | (kb[27] << 32) | (kb[28] << 40) | (kb[29] << 48))
    # v10: written word 2 + key bytes 30..31 + address byte 0
    out.append(wv[2] | (kb[30] << 32) | (kb[31] << 40) | (ab[0] << 48))
    # v11..v15: written words 3..7 + address bytes 1..15
    for i in range(5):
        b = 1 + 3 * i
        out.append(wv[3 + i] | (ab[b] << 32) | (ab[b + 1] << 40)
                   | (ab[b + 2] << 48))
    # v16: timestamp + address bytes 16..18
    out.append((q.timestamp & _M32) | (ab[16] << 32) | (ab[17] << 40)
               | (ab[18] << 48))
    # v17: tx number + address byte 19 + aux byte + shard id
    out.append((q.tx_number_in_block & _M32) | (ab[19] << 32)
               | ((q.aux_byte & 0xFF) << 40) | ((q.shard_id & 0xFF) << 48))
    # v18: rw flag + 2 * is_service; v19: rollback flag
    out.append((1 if q.rw_flag else 0) + 2 * (1 if getattr(q, "is_service", False) else 0))
    out.append(1 if q.rollback else 0)
    return out


def encode_timestamped_log_query(q: LogQuery, extended_timestamp: int) -> List[int]:
    """LogQueryWithExtendedEnumeration (log_query.rs:400-427): the raw
    encoding with the enumeration timestamp mixed into limb 19 at bit 8."""
    out = encode_log_query(q)
    out[EXTENDED_TIMESTAMP_ENCODING_ELEMENT] += (
        (extended_timestamp & _M32) << EXTENDED_TIMESTAMP_ENCODING_OFFSET)
    return out


def log_comparison_key(q: LogQuery) -> int:
    """13 LE u32 words [key x8, address x5] -> one comparable int
    (log_query.rs:82-92: address is most significant)."""
    return ((q.address & ((1 << 160) - 1)) << 256) | (q.key & ((1 << 256) - 1))


def event_comparison_key(q: LogQuery) -> int:
    """log_query.rs:94-98."""
    return q.timestamp & _M32


def encode_decommittment_request(q: DecommittmentQuery) -> List[int]:
    """decommittment_request.rs:6-73: code-hash words with page/timestamp/
    is_fresh bytes packed into the high bits of the first three limbs."""
    h = _u256_as_u32x8(q.hash)
    pb = _le_bytes(q.memory_page & _M32, 4)
    tb = _le_bytes(q.timestamp & _M32, 4)
    v0 = h[0] | (pb[0] << 32) | (pb[1] << 40) | (pb[2] << 48)
    v1 = h[1] | (pb[3] << 32) | (tb[0] << 40) | (tb[1] << 48)
    v2 = h[2] | (tb[2] << 32) | (tb[3] << 40) | ((1 if q.is_fresh else 0) << 48)
    return [v0, v1, v2, h[3], h[4], h[5], h[6], h[7]]


def encode_recursion_request(circuit_type: int,
                             public_input: Sequence[int]) -> List[int]:
    """recursion_request.rs:16-27: [type, pi0..pi3, 0, 0, 0]."""
    pi = list(public_input)
    assert len(pi) == 4
    return [int(circuit_type), *[int(v) for v in pi], 0, 0, 0]


def encode_extended_callstack_entry(
        entry, rollback_queue_head: Sequence[int],
        rollback_queue_tail: Sequence[int],
        rollback_queue_segment_length: int) -> List[int]:
    """callstack_entry.rs:34-178 (width 32). `entry` is vm.environment's
    CallStackEntry-like object; queue head/tail are 4-element states."""
    out: List[int] = [int(v) for v in rollback_queue_head]
    out += [int(v) for v in rollback_queue_tail]
    out += _address_as_u32x5(entry.code_address)
    out += _address_as_u32x5(entry.this_address)
    out += _address_as_u32x5(entry.msg_sender)
    ctx = int(getattr(entry, "context_u128_value", 0))
    out += [(ctx >> (32 * i)) & _M32 for i in range(4)]
    out.append((entry.code_page & _M32)
               | ((entry.pc & 0xFFFF) << 32)
               | ((entry.this_shard_id & 0xFF) << 48)
               | ((1 if getattr(entry, "is_static", False) else 0) << 56))
    out.append((entry.base_memory_page & _M32)
               | ((getattr(entry, "sp", 0) & 0xFFFF) << 32)
               | ((getattr(entry, "caller_shard_id", 0) & 0xFF) << 48)
               | ((1 if getattr(entry, "is_kernel_mode", False) else 0) << 56))
    out.append((entry.ergs_remaining & _M32)
               | ((getattr(entry, "exception_handler_location", 0) & 0xFFFF) << 32)
               | ((getattr(entry, "code_shard_id", 0) & 0xFF) << 48)
               | ((1 if getattr(entry, "is_local_frame", False) else 0) << 56))
    seg = _le_bytes(rollback_queue_segment_length & _M32, 4)
    out.append((getattr(entry, "heap_bound", 0) & _M32)
               | (seg[0] << 32) | (seg[1] << 40))
    out.append((getattr(entry, "aux_heap_bound", 0) & _M32)
               | (seg[2] << 32) | (seg[3] << 40))
    assert len(out) == EXECUTION_CONTEXT_RECORD_ENCODING_WIDTH
    return out


def serialize_l2_to_l1_message(q: LogQuery) -> bytes:
    """log_query.rs:503-534: shard | is_service | tx(2,BE) | address(20,BE) |
    key(32,BE) | written_value(32,BE) = 88 bytes."""
    out = (bytes([q.shard_id & 0xFF,
                  1 if getattr(q, "is_service", False) else 0])
           + (q.tx_number_in_block & 0xFFFF).to_bytes(2, "big")
           + q.address.to_bytes(20, "big")
           + q.key.to_bytes(32, "big")
           + q.written_value.to_bytes(32, "big"))
    assert len(out) == L2_TO_L1_MESSAGE_BYTE_LENGTH
    return out


def encode_state_diff_record(address: int, key: int, derived_key: bytes,
                             enumeration_index: int, initial_value: int,
                             final_value: int) -> bytes:
    """state_diff_record.rs:19-53: address(20) | key(32,BE) | derived_key(32)
    | enum_index(8,BE) | initial(32,BE) | final(32,BE) = 156 bytes."""
    assert len(derived_key) == 32
    out = (address.to_bytes(20, "big") + key.to_bytes(32, "big")
           + bytes(derived_key) + enumeration_index.to_bytes(8, "big")
           + initial_value.to_bytes(32, "big") + final_value.to_bytes(32, "big"))
    assert len(out) == STATE_DIFF_RECORD_BYTE_ENCODING_LEN
    return out


def decode_memory_query_fields(enc: Sequence[int]) -> Tuple[int, int, int, bool, bool, int]:
    """Inverse of encode_memory_query (used by tests to pin injectivity):
    returns (timestamp, page, index, rw_flag, is_ptr, value)."""
    ts = int(enc[0])
    page = int(enc[1])
    index = int(enc[2]) & _M32
    rw = bool((int(enc[2]) >> 32) & 1)
    ptr = bool((int(enc[2]) >> 33) & 1)
    w = [int(enc[3]) & _M32, int(enc[4]) & _M32, int(enc[5]) & _M32,
         int(enc[6]) & _M32, int(enc[7]) & _M32]
    hi_bytes = bytes([(int(enc[3]) >> s) & 0xFF for s in (32, 40, 48)]
                     + [(int(enc[4]) >> s) & 0xFF for s in (32, 40, 48)]
                     + [(int(enc[5]) >> s) & 0xFF for s in (32, 40, 48)]
                     + [(int(enc[6]) >> s) & 0xFF for s in (32, 40, 48)])
    w5 = int.from_bytes(hi_bytes[0:4], "little")
    w6 = int.from_bytes(hi_bytes[4:8], "little")
    w7 = int.from_bytes(hi_bytes[8:12], "little")
    value = sum(x << (32 * i) for i, x in enumerate(w + [w5, w6, w7]))
    return ts, page, index, rw, ptr, value
