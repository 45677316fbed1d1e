"""Artifact store: setup + per-block proof persistence with resume semantics.

Counterpart of the JAX package's `utils/data_source.py`.

Parity with the reference's `src/data_source/` (SURVEY L8): `SetupDataSource`
(VKs, finalization hints, padding proofs) + `BlockDataSource` (per-instance
proofs at every layer), with a JSON-file implementation using the reference's
naming scheme (`basic_circuit_proof_{type}_{idx}.json`,
`node_layer_proof_{type}_{step}_{idx}.json` — local_file_data_source.rs:29-57)
and an in-memory implementation (in_memory_data_source.rs:20-45).

This doubles as the checkpoint/resume system: every pipeline stage guards with
`if source.get_X() is None: compute; set_X` exactly like the reference
(complex_tests/mod.rs:323-331).

The JSON files hold a record's proofs in `utils/serde`'s form, and reading a
file decodes them again, so a record written by one run is resumed by the
next. (The JAX package's file store hands its records to `json.dump` as they
are, which refuses a proof object: its CLI `prove-block` stops at the first
proof it stores.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

from . import serde


class InMemoryDataSource:
    def __init__(self):
        self._store: Dict[Tuple, Any] = {}

    # -- generic ----------------------------------------------------------
    def get(self, *key) -> Optional[Any]:
        return self._store.get(tuple(key))

    def set(self, value, *key):
        self._store[tuple(key)] = value

    # -- setup layer ------------------------------------------------------
    def get_base_layer_vk(self, circuit_type: int):
        return self.get("base_vk", circuit_type)

    def set_base_layer_vk(self, vk, circuit_type: int):
        self.set(vk, "base_vk", circuit_type)

    def get_base_layer_finalization_hint(self, circuit_type: int):
        return self.get("base_hint", circuit_type)

    def set_base_layer_finalization_hint(self, hint, circuit_type: int):
        self.set(hint, "base_hint", circuit_type)

    def get_base_layer_padding_proof(self, circuit_type: int):
        return self.get("base_padding", circuit_type)

    def set_base_layer_padding_proof(self, proof, circuit_type: int):
        self.set(proof, "base_padding", circuit_type)

    def get_recursion_layer_vk(self, circuit_type: int):
        return self.get("recursion_vk", circuit_type)

    def set_recursion_layer_vk(self, vk, circuit_type: int):
        self.set(vk, "recursion_vk", circuit_type)

    def get_recursion_layer_finalization_hint(self, circuit_type: int):
        return self.get("recursion_hint", circuit_type)

    def set_recursion_layer_finalization_hint(self, hint, circuit_type: int):
        self.set(hint, "recursion_hint", circuit_type)

    def get_compression_vk(self, mode: int):
        return self.get("compression_vk", mode)

    def set_compression_vk(self, vk, mode: int):
        self.set(vk, "compression_vk", mode)

    def get_wrapper_setup(self):
        return self.get("wrapper_setup")

    def set_wrapper_setup(self, setup):
        self.set(setup, "wrapper_setup")

    def get_wrapper_vk(self):
        return self.get("wrapper_vk")

    def set_wrapper_vk(self, vk):
        self.set(vk, "wrapper_vk")

    # -- block layer ------------------------------------------------------
    def get_base_layer_proof(self, circuit_type: int, index: int):
        return self.get("base_proof", circuit_type, index)

    def set_base_layer_proof(self, proof, circuit_type: int, index: int):
        self.set(proof, "base_proof", circuit_type, index)

    def get_leaf_layer_proof(self, circuit_type: int, index: int):
        return self.get("leaf_proof", circuit_type, index)

    def set_leaf_layer_proof(self, proof, circuit_type: int, index: int):
        self.set(proof, "leaf_proof", circuit_type, index)

    def get_node_layer_proof(self, circuit_type: int, step: int, index: int):
        return self.get("node_proof", circuit_type, step, index)

    def set_node_layer_proof(self, proof, circuit_type: int, step: int, index: int):
        self.set(proof, "node_proof", circuit_type, step, index)

    def get_scheduler_proof(self):
        return self.get("scheduler_proof")

    def set_scheduler_proof(self, proof):
        self.set(proof, "scheduler_proof")

    def get_compression_proof(self, mode: int):
        return self.get("compression_proof", mode)

    def set_compression_proof(self, proof, mode: int):
        self.set(proof, "compression_proof", mode)

    def get_wrapper_proof(self):
        return self.get("wrapper_proof")

    def set_wrapper_proof(self, proof):
        self.set(proof, "wrapper_proof")


_FILE_NAMES = {
    "base_vk": "setup/base_layer/vk_{0}.json",
    "base_hint": "setup/base_layer/finalization_hint_{0}.json",
    "base_padding": "setup/base_layer/padding_proof_{0}.json",
    "recursion_vk": "setup/recursion_layer/vk_{0}.json",
    "recursion_hint": "setup/recursion_layer/finalization_hint_{0}.json",
    "compression_vk": "setup/aux_layer/compression_vk_{0}.json",
    "wrapper_setup": "setup/aux_layer/wrapper_setup.json",
    "wrapper_vk": "setup/aux_layer/wrapper_vk.json",
    "vk_digests": "setup/vk_digests.json",
    "eip4844_proof": "test_proofs/aux_layer/eip4844_proof_{0}.json",
    "base_proof": "test_proofs/base_layer/basic_circuit_proof_{0}_{1}.json",
    "leaf_proof": "test_proofs/recursion_layer/leaf_layer_proof_{0}_{1}.json",
    "node_proof": "test_proofs/recursion_layer/node_layer_proof_{0}_{1}_{2}.json",
    "scheduler_proof": "test_proofs/recursion_layer/scheduler_proof.json",
    "compression_proof": "test_proofs/aux_layer/compression_proof_{0}.json",
    "wrapper_proof": "test_proofs/aux_layer/wrapper_proof.json",
}


class LocalFileDataSource(InMemoryDataSource):
    """JSON files under a root dir, reference-compatible directory scheme."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root

    def _path(self, key) -> str:
        kind, args = key[0], key[1:]
        rel = _FILE_NAMES[kind].format(*args)
        return os.path.join(self.root, rel)

    def get(self, *key):
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return serde.proof_from_json(json.load(f),
                                         serde.default_registry())

    def set(self, value, *key):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(value, f, default=serde.proof_to_json)
