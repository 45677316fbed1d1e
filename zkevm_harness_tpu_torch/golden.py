"""The fixed small block behind the committed golden artifacts.

`test_artifacts/main_vm_log8_{vk,proof}.json` hold its MainVM instance
(`tools/gen_main_vm_golden.py`), and
`test_artifacts/{ram,events,storage,demux}_log8_{vk,proof}.json` the first
instance of each of its memory and log circuits (`tools/gen_sorter_golden.py`),
all proved with the JAX package. The port is held against them on the CPU
(tests) and on the card (`chip_smoke.py`). The block is given as a function
of an `isa` module, so that either package builds it from its own
instruction classes.

The hash block (`hash_block`) far-calls predeployed contracts and calls the
keccak and SHA-256 precompiles: it fills the hash circuits (keccak 5,
SHA-256 6, L1-messages hasher 13, code decommitter 3, decommitments sorter
2). Its small variant (`HASH_GOLDEN`) is behind
`test_artifacts/{keccak,sha256,hasher,decommitter,decommitts}_log*_*.json`
(`tools/gen_hash_golden.py`).

The whole block (`whole_block`) adds the MainVM loop body and ecrecover calls
to the hash block's rounds and fills all 13 base circuit types through
`witness.oracle.create_artifacts_from_tracer`. The golden ecrecover (toy
curve) and storage-application (depth 4) instances, the small whole block's
artifacts and the production VKs of types 7 and 10 are behind
`test_artifacts/{ecrecover_toy,storage_app_d4}_*.json`,
`whole_block_golden.json` and `vk_{7,10}_production.json`
(`tools/gen_block_golden.py`).

The recursion tower (`harness.run_block(tower=True)`) of the small block of
`tower_block` at `TOWER_GOLDEN_CONFIG` (RAM permutation 8 proved, its leaf,
node and scheduler) is behind `test_artifacts/tower_golden_*.json`, and
the dry block flow of `harness_block` behind
`test_artifacts/harness_dry_summary.json` (`tools/gen_tower_golden.py`);
storage application's tower at `leaf_arity=2` (`type10_block`,
`TYPE10_GOLDEN`) behind `test_artifacts/tower10_*.json`
(`tools/gen_type10_golden.py`).

The fib-mul AIR of the STARK engine and the stand-alone gadget circuits
(`gadget_circuits`), with fixed inputs, are behind
`test_artifacts/stark_fib_log6_proof.json` and
`test_artifacts/gadget_*_{vk,proof}.json` (`tools/gen_cli_golden.py`).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .circuits import ext_gadget as _eg
from .circuits import fri_fold_circuit as _fc
from .circuits import merkle_circuit as _mc
from .circuits import transcript_gadget as _tg
from .circuits.types import testing_geometry
from .ops import goldilocks as _gl
from .ops import merkle as _mk
from .prover import plonkish as _pk
from .utils import secp256k1 as _ec
from .vm import isa as _isa
from .vm.environment import (DefaultPrecompilesProcessor, InMemoryEventSink,
                             InMemoryStorage, SimpleDecommitter, SimpleMemory)
from .vm.interpreter import deploy_contract, run_vm
from .vm.state import BlockProperties, ProvingToolset, create_vm
from .witness.tracer import WitnessTracer

# VmGeometry(log_n, limb_bits, num_limbs): u128 registers, 2^8 rows
MAIN_VM_GEOMETRY = dict(log_n=8, limb_bits=8, num_limbs=16)
# PlonkishConfig of the golden proof
MAIN_VM_CONFIG = dict(rate=2, cap_size=4, num_queries=4, final_fri_size=8)
MAIN_VM_CYCLES = 200  # cycles of the block = capacity of its one instance
# Capacities per instance of the memory and log circuits of the golden
# artifacts. Each `*_geometry_for_capacity` of `prover/layers.py` turns them
# into the geometries of the JAX package's own tests: RamGeometry(8, 1),
# EventsGeometry(8, 2), DemuxGeometry(8, 3); and StorageGeometry(8, 11), the
# smallest that holds the block's one storage cell of 21 queries (an instance
# never splits a cell).
SORTER_CAPACITY = dict(ram=8, events=3, storage=21, demux=6)
# The small hash block of the golden artifacts: 2 rounds, each far-calling
# the one callee (one fresh and one repeated decommitment), whose code is one
# storage write, one L1 message and one add. It gives 2 keccak and 2 SHA-256
# calls, 4 L1 messages (3 keccak-f blocks), a 3-word bytecode (2 SHA-256
# blocks) and 2 decommitment queries.
HASH_GOLDEN = dict(rounds=2, call_every=1, callee_reps=(1,))
# Capacities per instance of the hash circuits of the golden artifacts; each
# `*_geometry_for_capacity` of `prover/layers.py` turns them into the
# geometries of the JAX package's own tests: KeccakGeometry(7) (4 slots),
# Sha256Geometry(8) (3 slots), HasherGeometry(7) (4 slots),
# DecommitterGeometry(8) (3 compressions), DecommittsGeometry(8, 1).
HASH_CAPACITY = dict(keccak=4, sha256=3, hasher=4, decommitter=3,
                     decommitts=8)
# The hash block at the size `chip_smoke.py` proves it: 293 rounds (1,520
# cycles: 293 keccak and 293 SHA-256 calls, 37 far calls of which 4 fresh,
# 128 storage queries (91 writes, 37 reads of the deployer mapping) and 384
# L1 messages), four callees of 1-4 repetitions.
HASH_BLOCK = dict(rounds=293, call_every=8, callee_reps=(1, 2, 3, 4))
HASH_CALLEE_BASE = 0xB0
KECCAK_ADDRESS = DefaultPrecompilesProcessor.KECCAK_ADDRESS
SHA256_ADDRESS = DefaultPrecompilesProcessor.SHA256_ADDRESS
ECRECOVER_ADDRESS = DefaultPrecompilesProcessor.ECRECOVER_ADDRESS
# The whole block (`whole_block`) fills all 13 base circuit types: the hash
# block's rounds, each after a `loop_body`, then ecrecover calls. At
# `WHOLE_BLOCK` and `GeometryConfig()` every type has at least one
# instance, and type 7 one full instance (7 calls, its capacity);
# `WHOLE_GOLDEN` is its small variant at `testing_geometry()`, behind
# `test_artifacts/whole_block_golden.json` (`tools/gen_block_golden.py`):
# one round, whose two L1 messages (the round's and the callee's) are all
# that geometry's single hasher instance takes.
WHOLE_BLOCK = dict(rounds=64, call_every=8, callee_reps=(1, 2, 3, 4),
                   ecrecover_calls=7)
WHOLE_GOLDEN = dict(rounds=1, call_every=1, callee_reps=(1,),
                    ecrecover_calls=1)
ECRECOVER_HEAP = 16          # heap word of the first ecrecover input
ECRECOVER_KEY = 0xA11CE      # signing key of call i: ECRECOVER_KEY + i
ECRECOVER_NONCE = 0xB0B123   # its nonce: ECRECOVER_NONCE + 7 i
# The golden type-7 instance: the recovery equation on a 61-bit toy curve
# y^2 = x^3 + 7 over 2^61 - 1 at 64-bit scalars and u8 limbs (the JAX
# package's own test curve), its generator the first point with x >= 3;
# the signature is that of key 3 with R = G and h = 0x1234.
ECRECOVER_TOY_P = (1 << 61) - 1
ECRECOVER_TOY_KEY = 3
ECRECOVER_TOY_HASH = 0x1234
# The golden type-10 instance: one depth-4 path (the JAX package's test
# path): leaf enumeration index 7, its value, the path bits and siblings.
STORAGE_APP_DEPTH = 4
STORAGE_APP_LEAF = ((7).to_bytes(8, "big")
                    + (0xBEEF_0000_1234).to_bytes(32, "big"))
STORAGE_APP_PATH_BITS = (1, 0, 1, 1)
STORAGE_APP_SIBLINGS = tuple(hashlib.blake2s(bytes([i])).digest()
                             for i in range(4))


# The config of the golden tower, base and recursion proofs alike, and the
# production config the card proves the whole block's tower at.
TOWER_GOLDEN_CONFIG = dict(rate=2, cap_size=4, num_queries=2,
                           final_fri_size=8)
TOWER_CONFIG = dict(rate=2, cap_size=16, num_queries=50, final_fri_size=512)
# The base types of the whole block's golden tower beyond the RAM
# permutation (8) and ecrecover (7), which the golden tower and the card's
# first tower covered, and storage application (10), whose six-path leaf
# the JAX package proves on a CPU in hours (its golden tower is
# `TYPE10_GOLDEN`'s, two paths): `harness.run_block(
# whole_block(WHOLE_GOLDEN), spot_types=TOWER13_GOLDEN_TYPES, tower=True)`
# at `TOWER_GOLDEN_CONFIG` is behind `test_artifacts/tower13_*.json`
# (`tools/gen_tower13_golden.py`).
TOWER13_GOLDEN_TYPES = (1, 2, 3, 4, 5, 6, 9, 11, 12, 13)
# Storage application's golden tower, that of the JAX package's own
# `tests/test_type10_tower.py`: `type10_block` (one storage write, so a
# read and a write path) at `testing_geometry()` with the storage tree cut
# to `depth`, one leaf of `leaf_arity` paths, its node and the scheduler,
# behind `test_artifacts/tower10_*.json` (`tools/gen_type10_golden.py`).
TYPE10_GOLDEN = dict(depth=STORAGE_APP_DEPTH, leaf_arity=2)
# The leaf arity of the whole block's tower on the card: type 10's 18 paths
# as 9 leaves of 2 and a node over them, type 3's 4 instances as 2 leaves
# and a node, the other types' single instance as it was.
TOWER_LEAF_ARITY = 2


def type10_block(isa) -> List:
    """A heap write and read and one storage write: the block of storage
    application's golden tower."""
    I = isa.imm
    return [isa.HeapWrite(I(0), I(5)), isa.HeapRead(I(0), 1),
            isa.StorageWrite(I(1), I(7)), isa.Ret()]


def tower_block(isa) -> List:
    """Three heap writes and reads: the block of the golden tower (its RAM
    permutation is the one type proved)."""
    I = isa.imm
    return [isa.HeapWrite(I(0), I(55)), isa.HeapRead(I(0), 2),
            isa.HeapWrite(I(1), I(66)), isa.HeapRead(I(1), 3),
            isa.HeapWrite(I(2), I(77)), isa.HeapRead(I(2), 4),
            isa.Ret()]


def harness_block(isa) -> List:
    """Storage, events, L1 messages, heap and a near call: the block of the
    golden dry block flow."""
    I = isa.imm
    return [isa.StorageWrite(I(1), I(100)), isa.StorageRead(I(1), 1),
            isa.Event(I(2), I(3)), isa.Event(I(4), I(5), to_l1=True),
            isa.HeapWrite(I(0), I(55)), isa.HeapRead(I(0), 2),
            isa.NearCall(target=8, exception_handler=7), isa.Ret(),
            isa.StorageWrite(I(9), I(200)), isa.Ret()]


def ecrecover_toy_curve() -> dict:
    """The toy curve as `CurveParams` fields."""
    p = ECRECOVER_TOY_P
    x = 3
    while True:
        v = (x * x * x + 7) % p
        y = pow(v, (p + 1) // 4, p)
        if y * y % p == v:
            return dict(p=p, b=7, g=(x, y), scalar_bits=64, limb_bits=8)
        x += 1


def ecrecover_toy_signature() -> Tuple[int, int, int, Tuple[int, int], int]:
    """(h, r, s, Q, y of R) on the toy curve with s*R == r*Q + h*G over the
    integers: R = G, Q = 3 G, s = r * 3 + h."""
    c = ecrecover_toy_curve()
    p, g = c["p"], c["g"]

    def add(p1, p2):
        if p1 is None:
            return p2
        (x1, y1), (x2, y2) = p1, p2
        if p1 == p2:
            lam = 3 * x1 * x1 * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    q = None
    for _ in range(ECRECOVER_TOY_KEY):
        q = add(q, g)
    r = g[0]
    return (ECRECOVER_TOY_HASH, r, r * ECRECOVER_TOY_KEY + ECRECOVER_TOY_HASH,
            q, g[1])


def loop_body(isa) -> List:
    """Eight instructions of arithmetic, division, heap, storage and event
    traffic: the round that the full-size MainVM workload repeats."""
    I, R = isa.imm, isa.reg
    return [
        isa.BinOp("add", R(1), I(1), dst=1),
        isa.BinOp("add", R(1), R(2), dst=2),
        isa.Div(R(2), I(7), dst_quot=3, dst_rem=4),
        isa.HeapWrite(I(3), R(2)),
        isa.HeapRead(I(3), 5),
        isa.StorageWrite(I(5), R(5)),
        isa.Event(I(6), R(3)),
        isa.BinOp("sub", R(2), R(3), dst=6),
    ]


def main_vm_block(isa) -> List:
    """A 200-cycle block: twenty rounds of `loop_body`, then multiply,
    bitwise ops, shifts, a taken conditional jump and a near call, padded
    with Nops up to the final Ret."""
    I, R = isa.imm, isa.reg
    prog = loop_body(isa) * 20
    base = len(prog)  # 160
    prog += [
        isa.BinOp("mul", R(2), I(0x1234), dst=7),
        isa.BinOp("and", R(7), I(0xFF00), dst=8),
        isa.BinOp("or", R(8), I(0x00FF), dst=9),
        isa.BinOp("xor", R(9), R(7), dst=10),
        isa.BinOp("shl", R(7), I(37), dst=11),
        isa.BinOp("shr", R(11), I(21), dst=12),
        isa.StorageRead(I(5), 13),
        isa.BinOp("sub", R(13), R(5), dst=14),           # 0: eq flag set
        isa.JumpIfEq(target=base + 10),                  # taken
        isa.Nop(),                                       # skipped
        isa.NearCall(target=MAIN_VM_CYCLES,
                     exception_handler=MAIN_VM_CYCLES - 1),  # base + 10
    ]
    # one instruction is skipped and two run in the callee: the root Ret at
    # pc 198 is cycle 200
    prog += [isa.Nop()] * (MAIN_VM_CYCLES - 2 - len(prog)) + [isa.Ret()]
    prog += [
        isa.Ret(panic=True),                             # handler (unused)
        isa.BinOp("add", R(12), I(10), dst=15),          # callee
        isa.Ret(),
    ]
    return prog


def hash_callees(isa, callee_reps: Sequence[int]
                 ) -> List[Tuple[int, List]]:
    """(address, code) of the hash block's callees: callee k, at
    0xB0 + k, repeats a storage write, an L1 message and an add
    `callee_reps[k]` times, then returns."""
    I = isa.imm
    return [(HASH_CALLEE_BASE + k,
             [isa.StorageWrite(I(100 + k), I(7 + k)),
              isa.Event(I(k), I(k + 1), to_l1=True),
              isa.BinOp("add", I(k), I(1), dst=1)] * reps + [isa.Ret()])
            for k, reps in enumerate(callee_reps)]


def _hash_rounds(isa, rounds: int, call_every: int,
                 callee_reps: Sequence[int], prefix=()) -> List:
    """`rounds` rounds r of the instructions `prefix`, an add, a keccak call
    on r1, a SHA-256 call on r2, an L1 message, and, when
    r % call_every == 0, a far call to callee (r // call_every) % callees
    whose exception handler is the next instruction."""
    I, R = isa.imm, isa.reg
    prog: List = []
    for r in range(rounds):
        prog += list(prefix) + [
            isa.BinOp("add", R(1), I(1), dst=1),
            isa.Precompile(KECCAK_ADDRESS, R(1), 2),
            isa.Precompile(SHA256_ADDRESS, R(2), 3),
            isa.Event(I(r), R(3), to_l1=True),
        ]
        if r % call_every == 0:
            callee = HASH_CALLEE_BASE + (r // call_every) % len(callee_reps)
            prog.append(isa.FarCall(I(callee),
                                    exception_handler=len(prog) + 1))
    return prog


def hash_block(isa, rounds: int, call_every: int = 8,
               callee_reps: Sequence[int] = (1, 2, 3, 4)) -> List:
    """The entry code of the hash block: `rounds` rounds r of an add, a
    keccak call on r1, a SHA-256 call on r2, an L1 message, and, when
    r % call_every == 0, a far call to callee (r // call_every) % callees
    whose exception handler is the next instruction; then Ret."""
    return _hash_rounds(isa, rounds, call_every, callee_reps) + [isa.Ret()]


def ecrecover_inputs(count: int) -> List[bytes]:
    """`count` 128-byte ecrecover inputs h || v || r || s (v the parity of
    R, 0 or 1), each a valid secp256k1 signature of a fixed hash by a fixed
    key and nonce."""
    out = []
    for i in range(count):
        msg = _ec.keccak256(b"whole block ecrecover %d" % i)
        v, r, s = _ec.sign(msg, ECRECOVER_KEY + i, ECRECOVER_NONCE + 7 * i)
        out.append(msg + b"".join(x.to_bytes(32, "big") for x in (v, r, s)))
    return out


def whole_block(isa, rounds: int, call_every: int = 8,
                callee_reps: Sequence[int] = (1, 2, 3, 4),
                ecrecover_calls: int = 7) -> List:
    """The entry code of the whole block, which fills all 13 base circuit
    types: `rounds` rounds of `loop_body` followed by the hash block's round
    (keccak and SHA-256 calls, an L1 message, a far call every
    `call_every` rounds), then `ecrecover_calls` ecrecover calls, each
    writing h || v || r || s as four heap words from `ECRECOVER_HEAP` and
    calling the precompile on them; then Ret."""
    I = isa.imm
    prog = _hash_rounds(isa, rounds, call_every, callee_reps,
                        prefix=loop_body(isa))
    for i, data in enumerate(ecrecover_inputs(ecrecover_calls)):
        base = ECRECOVER_HEAP + 4 * i
        for k in range(4):
            prog.append(isa.HeapWrite(
                I(base + k), I(int.from_bytes(data[32 * k:32 * k + 32],
                                              "big"))))
        prog.append(isa.Precompile(ECRECOVER_ADDRESS, I(base), 7,
                                   data_words=4))
    return prog + [isa.Ret()]


def trace_program(program: List, cycle_limit: int,
                  contracts: Sequence[Tuple[int, List]] = ()
                  ) -> WitnessTracer:
    """Run `program` (instructions of the port's `vm.isa`) to its end in a
    fresh VM with in-memory storage, memory and event sink, after deploying
    each (address, code) of `contracts`, and return the tracer that
    recorded it."""
    return _run(program, cycle_limit, contracts)[0]


def _run(program: List, cycle_limit: int,
         contracts: Sequence[Tuple[int, List]]
         ) -> Tuple[WitnessTracer, Dict[Tuple[int, int, int], int]]:
    tracer = WitnessTracer(cycle_limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=testing_geometry())
    for address, code in contracts:
        deploy_contract(tools, address, code)
    pre_state = dict(tools.storage.inner)
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    run_vm(vm, program, cycle_limit)
    if not vm.finished:
        raise RuntimeError(f"program still running after {cycle_limit} cycles")
    return tracer, pre_state


def trace_whole_block(rounds: int, call_every: int = 8,
                      callee_reps: Sequence[int] = (1, 2, 3, 4),
                      ecrecover_calls: int = 7
                      ) -> Tuple[WitnessTracer, Dict[Tuple[int, int, int],
                                                      int]]:
    """(tracer, pre-state) of the whole block run by the port's VM after
    its callees are deployed: the pre-state is the storage after the
    deployment and before the run, `{(shard, address, key): value}`, the
    `initial_storage` of `witness.oracle.create_artifacts_from_tracer`."""
    prog = whole_block(_isa, rounds, call_every, callee_reps, ecrecover_calls)
    return _run(prog, 8 * len(prog) + 64, hash_callees(_isa, callee_reps))


def trace_main_vm_block() -> WitnessTracer:
    """The golden block, traced by the port's VM."""
    return trace_program(main_vm_block(_isa), 1000)


def trace_hash_block(rounds: int, call_every: int = 8,
                     callee_reps: Sequence[int] = (1, 2, 3, 4)
                     ) -> WitnessTracer:
    """The hash block, traced by the port's VM with its callees deployed
    through `vm.interpreter.deploy_contract`."""
    prog = hash_block(_isa, rounds, call_every, callee_reps)
    return trace_program(prog, 8 * len(prog) + 64,
                         hash_callees(_isa, callee_reps))


# -- the AIR STARK engine and the gadget circuits, at the shapes of the JAX
# package's tests of them -----------------------------------------------------

# StarkConfig of the golden STARK proof and the rows of its trace
STARK_GOLDEN_CONFIG = dict(lde_factor=4, cap_size=4, num_queries=10,
                           final_fri_size=16)
STARK_GOLDEN_LOG_N = 6
# (row, column, value) assertions of the fib-mul AIR
FIB_MUL_BOUNDARY = ((0, 0, 1), (0, 1, 1), (0, 2, 1))


def fib_mul_transitions(alg, row, nxt):
    """Width 3: a' = b, b' = a + b, c' = c * b (degree 2), against either
    algebra of `prover/stark.py`."""
    a, b, c = row
    an, bn, cn = nxt
    return [alg.sub(an, b), alg.sub(bn, alg.add(a, b)),
            alg.sub(cn, alg.mul(c, b))]


def fib_mul_trace(log_n: int) -> List[List[int]]:
    """The fib-mul trace as three columns of Python ints."""
    p = (1 << 64) - (1 << 32) + 1
    a = b = c = 1
    cols = [[], [], []]
    for _ in range(1 << log_n):
        for col, v in zip(cols, (a, b, c)):
            col.append(v)
        a, b, c = b, (a + b) % p, (c * b) % p
    return cols


def fixed_words(tag: str, count: int) -> List[int]:
    """`count` fixed field values in [1, 2^62), from SHA-256 of the tag
    and the index (the same on every machine, whatever its numpy)."""
    return [int.from_bytes(hashlib.sha256(f"{tag}/{i}".encode()).digest()[:8],
                           "big") % ((1 << 62) - 1) + 1 for i in range(count)]


def _pairs(tag: str, count: int) -> List[Tuple[int, int]]:
    w = fixed_words(tag, 2 * count)
    return [(w[2 * i], w[2 * i + 1]) for i in range(count)]


# PlonkishConfigs of the gadget tests (final FRI size 8, or 16)
GADGET_CONFIG = dict(rate=2, cap_size=4, num_queries=8, final_fri_size=8)
GADGET_CONFIG_16 = dict(rate=2, cap_size=4, num_queries=8, final_fri_size=16)
EXT_CHAIN_LOG_N = 4
EXT_CHAIN_BASE = _pairs("ext_chain", 1)[0]
INVERSE_LOG_N = 5
INVERSE_XS = tuple(fixed_words("inverse", 8))
FRI_FOLD_LOG_N = 5
FRI_FOLD_ROWS = tuple((a, b, al, d) for (a, b, al), d in zip(
    zip(_pairs("fold_a", 10), _pairs("fold_b", 10), _pairs("fold_alpha", 10)),
    fixed_words("fold_d", 10)))
TRANSCRIPT_LOG_N = 6
TRANSCRIPT_BLOCKS = (0, 1)
TRANSCRIPT_CHUNKS = tuple(tuple(fixed_words(f"transcript_{k}", 8))
                          for k in range(2))
MERKLE_LOG_N = 6
MERKLE_LEAVES = tuple(tuple(fixed_words(f"merkle_leaf_{i}", 4))
                      for i in range(4))
MERKLE_INDEX = 2


def gadget_circuits(device=None):
    """The five golden gadget circuits of the port, each as (name, ir,
    setup, witness, PlonkishConfig) on `device` (`None` means the CUDA card):
    the names of test_artifacts/gadget_{name}_{vk,proof}.json."""
    cfg8 = _pk.PlonkishConfig(**GADGET_CONFIG)
    cfg16 = _pk.PlonkishConfig(**GADGET_CONFIG_16)
    out = []
    ir = _eg.ext_chain_ir(EXT_CHAIN_LOG_N)
    out.append(("ext_chain", ir, _eg.ext_chain_setup(ir, cfg8, device),
                _eg.ext_chain_witness(ir, EXT_CHAIN_BASE, device), cfg8))
    ir = _eg.inverse_ir(INVERSE_LOG_N)
    out.append(("inverse", ir,
                _eg.inverse_setup(ir, cfg8, len(INVERSE_XS), device),
                _eg.inverse_witness(ir, INVERSE_XS, device), cfg8))
    ir = _fc.fold_ir(FRI_FOLD_LOG_N)
    out.append(("fri_fold", ir,
                _fc.fold_setup(ir, [r[3] for r in FRI_FOLD_ROWS], cfg8,
                               device),
                _fc.fold_witness(ir, FRI_FOLD_ROWS, device)[0], cfg8))
    ir = _tg.transcript_ir(TRANSCRIPT_LOG_N, TRANSCRIPT_BLOCKS)
    out.append(("transcript", ir, _tg.transcript_setup(ir, cfg16, device),
                _tg.transcript_witness(ir, TRANSCRIPT_CHUNKS, device), cfg16))
    leaves = _gl.from_int(np.array(MERKLE_LEAVES, dtype=object), device)
    path = _gl.to_u64(_mk.open_indices(_mk.build_tree(leaves, 1), np.array(
        [MERKLE_INDEX], np.uint32)))[0]
    ir = _mc.merkle_ir(MERKLE_LOG_N)
    witness, _root = _mc.merkle_witness(
        ir, list(MERKLE_LEAVES[MERKLE_INDEX]),
        [[int(v) for v in lvl] for lvl in path],
        [(MERKLE_INDEX >> d) & 1 for d in range(path.shape[0])], device)
    out.append(("merkle", ir, _mc.merkle_setup(ir, cfg16, device), witness,
                cfg16))
    return out
