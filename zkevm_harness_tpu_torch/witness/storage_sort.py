"""Storage-access sort + dedup with slot-history semantics.

Behavioral parity with `sort_storage_access_queries`
(circuit_sequencer_api/src/sort_storage_access.rs:19-260): stable-sort all
storage log queries by (shard, address, key, order-of-appearance), then per
slot replay the write/rollback stack to derive the *net* access:
  - no depth-zero read and no net change -> slot dropped entirely;
  - net unchanged but read at depth zero -> "protective read" query;
  - net changed -> single write query (initial_value -> final value).

The per-slot replay asserts the same invariants the reference does (reads see
current value; rollbacks match their writes). The sort itself is the TPU-sort
candidate (witness/queues.sort_by_u64_keys); the replay is linear host work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..vm.environment import LogQuery


@dataclasses.dataclass
class LogQueryWithExtendedEnumeration:
    raw_query: LogQuery
    extended_timestamp: int


def sort_storage_access_queries(queries: List[LogQuery]
                                ) -> Tuple[List[LogQueryWithExtendedEnumeration],
                                           List[LogQuery]]:
    with_ts = [LogQueryWithExtendedEnumeration(q, i)
               for i, q in enumerate(queries)]
    with_ts.sort(key=lambda e: (e.raw_query.shard_id, e.raw_query.address,
                                e.raw_query.key, e.extended_timestamp))

    deduplicated: List[LogQuery] = []
    i = 0
    n = len(with_ts)
    while i < n:
        cand = with_ts[i].raw_query
        group = []
        while i < n and (with_ts[i].raw_query.shard_id == cand.shard_id
                         and with_ts[i].raw_query.address == cand.address
                         and with_ts[i].raw_query.key == cand.key):
            group.append(with_ts[i])
            i += 1

        initial = None
        current = None
        changes: List[LogQueryWithExtendedEnumeration] = []
        did_read_at_depth_zero = False
        for el in group:
            q = el.raw_query
            if current is None:
                if not q.rw_flag:
                    did_read_at_depth_zero = True
                assert not (q.rw_flag and q.rollback)
                initial = q.read_value
                current = q.read_value
            elif not q.rw_flag and not changes:
                did_read_at_depth_zero = True
            if not q.rw_flag:
                assert q.read_value == current, f"read sees stale value: {q}"
            else:
                if not q.rollback:
                    assert q.read_value == current, f"write sees stale: {q}"
                    current = q.written_value
                    changes.append(el)
                else:
                    popped = changes.pop()
                    pq = popped.raw_query
                    assert (q.read_value, q.written_value) == \
                        (pq.read_value, pq.written_value)
                    assert q.written_value == current
                    current = q.read_value

        if not did_read_at_depth_zero and not changes:
            assert initial == current
            continue  # never observed, no net change: drop
        if initial == current:
            if did_read_at_depth_zero:
                deduplicated.append(LogQuery(
                    timestamp=0, tx_number_in_block=0, aux_byte=cand.aux_byte,
                    shard_id=cand.shard_id, address=cand.address, key=cand.key,
                    read_value=initial, written_value=current, rw_flag=False))
        else:
            deduplicated.append(LogQuery(
                timestamp=0, tx_number_in_block=0, aux_byte=cand.aux_byte,
                shard_id=cand.shard_id, address=cand.address, key=cand.key,
                read_value=initial, written_value=current, rw_flag=True))

    return with_ts, deduplicated
