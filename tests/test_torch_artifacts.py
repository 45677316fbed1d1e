"""The port's test-artifact infrastructure and sequencer API against the JAX
package's: an artifact's JSON file is the JAX file byte for byte and loads
back in either package; predeploying it gives the same code hashes and
state-tree root and the entry code runs; the queue commitments of
`sequencer_api` equal the JAX package's."""

import dataclasses

import pytest

from tests.test_vm import make_vm as jax_make_vm
from zkevm_harness_tpu.utils import sequencer_api as jsa
from zkevm_harness_tpu.utils import test_artifacts as jta
from zkevm_harness_tpu.vm import environment as jenv
from zkevm_harness_tpu.vm import isa as jisa
from zkevm_harness_tpu.vm.interpreter import run_vm as jax_run_vm
from zkevm_harness_tpu.witness.tree import SparseStorageTree as JaxTree
from zkevm_harness_tpu_torch.circuits import types as ctypes
from zkevm_harness_tpu_torch.utils import sequencer_api as tsa
from zkevm_harness_tpu_torch.utils import test_artifacts as tta
from zkevm_harness_tpu_torch.vm import environment as tenv
from zkevm_harness_tpu_torch.vm import isa as tisa
from zkevm_harness_tpu_torch.vm.interpreter import run_vm
from zkevm_harness_tpu_torch.vm.state import (BlockProperties, ProvingToolset,
                                              create_vm)
from zkevm_harness_tpu_torch.witness.tracer import WitnessTracer
from zkevm_harness_tpu_torch.witness.tree import SparseStorageTree


def make_artifact(ta, isa):
    I = isa.imm
    callee = [isa.StorageWrite(I(1), I(500)), isa.Event(I(2), I(3)),
              isa.Ret()]
    entry = [isa.FarCall(I(0xCAFE), exception_handler=2), isa.Ret(),
             isa.Ret()]
    return ta.TestArtifact(entry_point_address=0xAA, entry_point_code=entry,
                           predeployed_contracts={0xCAFE: callee,
                                                  0xBEEF: entry[1:]})


def make_vm():
    tracer = WitnessTracer(5)
    tools = ProvingToolset(
        storage=tenv.InMemoryStorage(), memory=tenv.SimpleMemory(),
        decommitter=tenv.SimpleDecommitter(),
        event_sink=tenv.InMemoryEventSink(),
        precompiles=tenv.DefaultPrecompilesProcessor(), tracer=tracer,
        geometry=ctypes.testing_geometry())
    vm = create_vm(tools, BlockProperties(block_number=1), entry_address=0xAA,
                   code_page=0)
    return vm, tracer, tools


def test_artifact_json_equals_jax_bytes(tmp_path):
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tta.save_artifact(make_artifact(tta, tisa), tpath)
    jta.save_artifact(make_artifact(jta, jisa), jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    back = tta.load_artifact(jpath)
    assert back == make_artifact(tta, tisa)
    assert jta.load_artifact(tpath) == make_artifact(jta, jisa)


def test_predeploy_and_run_equal_jax(tmp_path):
    path = str(tmp_path / "artifact.json")
    tta.save_artifact(make_artifact(tta, tisa), path)
    art, jart = tta.load_artifact(path), jta.load_artifact(path)

    vm, _tracer, tools = make_vm()
    tree = SparseStorageTree()
    hashes = tta.save_predeployed_contracts(tools, tree, art)
    jvm, _jtracer, jtools = jax_make_vm()
    jtree = JaxTree()
    assert hashes == jta.save_predeployed_contracts(jtools, jtree, jart)
    assert tree.root == jtree.root != SparseStorageTree().root
    run_vm(vm, art.entry_point_code, 100)
    jax_run_vm(jvm, jart.entry_point_code, 100)
    assert vm.finished and jvm.finished
    assert tools.storage.read(0, 0xCAFE, 1) == 500
    assert tools.storage.inner == jtools.storage.inner
    # without a tree, only the toolset is written
    _vm, _t, tools2 = make_vm()
    assert tta.save_predeployed_contracts(tools2, None, art) == hashes


def _log_queries(env, count):
    return [env.LogQuery(timestamp=3 * i + 1, tx_number_in_block=i % 2,
                         aux_byte=1, shard_id=0, address=0x8000 + i,
                         key=(i * 0x9E3779B97F4A7C15) % (1 << 256),
                         read_value=0, written_value=(7 * i + 1) << 200,
                         rw_flag=True)
            for i in range(count)]


# the JAX queue simulator compiles its chain for 10-15 s a length
@pytest.mark.parametrize("count", [0, pytest.param(5, marks=pytest.mark.slow)])
def test_events_queue_commitment_equals_jax(count):
    got = tsa.events_queue_commitment(_log_queries(tenv, count), device="cpu")
    assert got == jsa.events_queue_commitment(_log_queries(jenv, count))
    assert len(got) == 4


def test_initial_heap_content_commitment_equals_jax():
    words = [0, 1, (1 << 256) - 1, 0xDEADBEEF << 128, 42]
    got = tsa.initial_heap_content_commitment(words, device="cpu")
    assert got == jsa.initial_heap_content_commitment(words)
    assert len(got) == 12


def test_reexports():
    assert dataclasses.asdict(tsa.GeometryConfig()) == \
        dataclasses.asdict(jsa.GeometryConfig())
    queries = [dataclasses.replace(q, aux_byte=0, rw_flag=bool(i % 2))
               for i, q in enumerate(_log_queries(tenv, 6))]
    assert tsa.sort_storage_access_queries(queries) is not None
