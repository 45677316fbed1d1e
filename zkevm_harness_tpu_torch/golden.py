"""The fixed small block behind the committed golden artifacts.

`test_artifacts/main_vm_log8_{vk,proof}.json` hold its MainVM instance
(`tools/gen_main_vm_golden.py`), and
`test_artifacts/{ram,events,storage,demux}_log8_{vk,proof}.json` the first
instance of each of its memory and log circuits (`tools/gen_sorter_golden.py`),
all proved with the JAX package. The port is held against them on the CPU
(tests) and on the card (`chip_smoke.py`). The block is given as a function
of an `isa` module, so that either package builds it from its own
instruction classes.
"""

from __future__ import annotations

from typing import List

from .circuits.types import testing_geometry
from .vm import isa as _isa
from .vm.environment import (DefaultPrecompilesProcessor, InMemoryEventSink,
                             InMemoryStorage, SimpleDecommitter, SimpleMemory)
from .vm.interpreter import run_vm
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


def trace_program(program: List, cycle_limit: int) -> WitnessTracer:
    """Run `program` (instructions of the port's `vm.isa`) to its end in a
    fresh VM with in-memory storage, memory and event sink, and return the
    tracer that recorded it."""
    tracer = WitnessTracer(cycle_limit)
    tools = ProvingToolset(
        storage=InMemoryStorage(), memory=SimpleMemory(),
        decommitter=SimpleDecommitter(), event_sink=InMemoryEventSink(),
        precompiles=DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=testing_geometry())
    vm = create_vm(tools, BlockProperties(block_number=1), 0xAA, code_page=0)
    run_vm(vm, program, cycle_limit)
    if not vm.finished:
        raise RuntimeError(f"program still running after {cycle_limit} cycles")
    return tracer


def trace_main_vm_block() -> WitnessTracer:
    """The golden block, traced by the port's VM."""
    return trace_program(main_vm_block(_isa), 1000)
