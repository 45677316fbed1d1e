"""Test-artifact infrastructure: block fixtures for end-to-end tests.

Counterpart of the JAX package's `utils/test_artifacts.py`; the JSON form is
the same, byte for byte. Parity with the reference's test-artifact infra (SURVEY component 19:
`TestArtifact{entry_point_address, entry_point_code, default_account_code,
predeployed_contracts}` + `save_predeployed_contracts`,
src/helper/artifact_utils.rs / tests/complex_tests/utils.rs). The reference
fetches solc-compiled contracts from the network; this framework's artifacts
are structured-ISA programs stored as JSON (zero-egress image), loaded and
predeployed into the toolset + state tree before a run.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from ..vm import isa
from ..witness.tree import SparseStorageTree


@dataclasses.dataclass
class TestArtifact:
    entry_point_address: int
    entry_point_code: List[isa.Instruction]
    predeployed_contracts: Dict[int, List[isa.Instruction]]


_ISA_TYPES = {cls.__name__: cls for cls in
              (isa.Nop, isa.BinOp, isa.Jump, isa.JumpIfEq, isa.HeapWrite,
               isa.HeapRead, isa.StorageWrite, isa.StorageRead, isa.Event,
               isa.NearCall, isa.Ret, isa.Precompile, isa.FarCall,
               isa.FarCallData, isa.RetData, isa.PtrRead)}


def _encode_instr(i: isa.Instruction):
    def enc(v):
        if isinstance(v, isa.Operand):
            return {"kind": v.kind, "value": v.value}
        return v

    return {"op": type(i).__name__,
            **{f.name: enc(getattr(i, f.name)) for f in dataclasses.fields(i)}}


def _decode_instr(d: dict) -> isa.Instruction:
    cls = _ISA_TYPES[d["op"]]
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict) and set(v) == {"kind", "value"}:
            v = isa.Operand(v["kind"], v["value"])
        kwargs[f.name] = v
    return cls(**kwargs)


def save_artifact(artifact: TestArtifact, path: str):
    with open(path, "w") as f:
        json.dump({
            "entry_point_address": artifact.entry_point_address,
            "entry_point_code": [_encode_instr(i)
                                 for i in artifact.entry_point_code],
            "predeployed_contracts": {
                str(a): [_encode_instr(i) for i in code]
                for a, code in artifact.predeployed_contracts.items()},
        }, f, indent=1)


def load_artifact(path: str) -> TestArtifact:
    with open(path) as f:
        d = json.load(f)
    return TestArtifact(
        entry_point_address=int(d["entry_point_address"]),
        entry_point_code=[_decode_instr(i) for i in d["entry_point_code"]],
        predeployed_contracts={int(a): [_decode_instr(i) for i in code]
                               for a, code in
                               d["predeployed_contracts"].items()})


def save_predeployed_contracts(tools, tree: Optional[SparseStorageTree],
                               artifact: TestArtifact) -> Dict[int, int]:
    """Predeploy every contract: decommitter + deployer mapping (+ the state
    tree's deployer slots, mirroring tests/mod.rs:38-96). Returns
    address -> code hash."""
    from ..vm.interpreter import DEPLOYER_ADDRESS, deploy_contract
    from ..witness.storage_application import storage_key_to_index

    hashes = {}
    for address, code in artifact.predeployed_contracts.items():
        h = deploy_contract(tools, address, code)
        hashes[address] = h
        if tree is not None:
            tree.insert_leaf(storage_key_to_index(DEPLOYER_ADDRESS, address),
                             h.to_bytes(32, "big"))
    return hashes
