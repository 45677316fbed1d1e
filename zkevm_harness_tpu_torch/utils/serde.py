"""JSON serialization of proofs/VKs/setup artifacts.

Plays the role of the reference's serde_json derives on boojum
`Proof`/`VerificationKey` (the bit-exactness contract of SURVEY §4: artifacts
under setup/ and test_proofs/ are JSON). Field elements serialize as decimal
strings (u64-safe in JSON), digests as 4-element lists, nested structures as
plain dicts — stable and diffable. Same JSON as the JAX package's
`utils/serde.py`, so a proof of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


def _encode(obj: Any) -> Any:
    if isinstance(obj, (bool, str, type(None))):
        return obj
    if isinstance(obj, (int, np.integer)):
        return str(int(obj)) if int(obj) > 2**53 else int(obj)
    if isinstance(obj, float):
        return obj
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, np.ndarray):
        return {"__array__": [_encode(v) for v in obj.ravel().tolist()],
                "shape": list(obj.shape)}
    if isinstance(obj, dict):
        return {"__dict__": [[_encode(k), _encode(v)] for k, v in obj.items()]}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        return {"__dataclass__": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode(obj: Any, registry) -> Any:
    if isinstance(obj, str):
        if obj.lstrip("-").isdigit():
            return int(obj)
        return obj
    if isinstance(obj, list):
        return [_decode(v, registry) for v in obj]
    if isinstance(obj, dict):
        if "__bytes__" in obj:
            return bytes.fromhex(obj["__bytes__"])
        if "__tuple__" in obj:
            return tuple(_decode(v, registry) for v in obj["__tuple__"])
        if "__array__" in obj:
            vals = [_decode(v, registry) for v in obj["__array__"]]
            return np.array(vals, dtype=object).reshape(obj["shape"])
        if "__dict__" in obj:
            return {_decode(k, registry): _decode(v, registry)
                    for k, v in obj["__dict__"]}
        if "__dataclass__" in obj:
            cls = registry[obj["__dataclass__"]]
            return cls(**{k: _decode(v, registry)
                          for k, v in obj["fields"].items()})
        return {k: _decode(v, registry) for k, v in obj.items()}
    return obj


def proof_to_json(proof) -> Any:
    """Dataclass proof -> JSON-safe structure."""
    return _encode(proof)


def proof_from_json(data: Any, registry: dict) -> Any:
    """JSON structure -> proof; registry maps dataclass names to classes."""
    return _decode(data, registry)


def default_registry() -> dict:
    from ..prover.fri import FriLayerOpening, FriProof
    from ..prover.plonkish import PlonkishProof
    from ..prover.stark import StarkProof

    return {c.__name__: c for c in
            (FriProof, FriLayerOpening, PlonkishProof, StarkProof)}
