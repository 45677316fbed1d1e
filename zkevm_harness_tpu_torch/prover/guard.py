"""Structural-error guard for verifier entry points.

A verifier must REJECT a malformed proof (wrong lengths, bad types,
truncated openings), never crash on it — but silently swallowing every
exception can also hide INTERNAL verifier bugs (an invariant assert firing
on a well-formed proof). This guard separates the two concerns:

  - default (tolerant): structural exceptions reject (return False) and are
    counted via utils.tracing (`verify_structural_reject`), so a swallowed
    exception is observable rather than invisible;
  - strict mode (`strict=True` or env `ZKEVM_VERIFY_STRICT=1`): exceptions
    propagate, so internal invariant failures surface in development and CI
    debugging instead of masquerading as "proof rejected".

(Reference behavior: boojum's verifier returns a bool and relies on typed
deserialization for shape errors; here proofs are plain pytrees, so the
shape surface is wider and needs an explicit guard.)
"""

from __future__ import annotations

import os
from typing import Callable

from ..utils import tracing

_STRUCTURAL = (TypeError, ValueError, KeyError, IndexError, AssertionError)


def strict_default() -> bool:
    return os.environ.get("ZKEVM_VERIFY_STRICT", "") not in ("", "0")


def tolerant_verify(inner: Callable[..., bool], *args,
                    strict: bool = None, **kwargs) -> bool:
    if strict is None:
        strict = strict_default()
    if strict:
        return bool(inner(*args, **kwargs))
    try:
        return bool(inner(*args, **kwargs))
    except _STRUCTURAL as e:
        tracing.count("verify_structural_reject")
        tracing.count(f"verify_structural_reject/{type(e).__name__}")
        return False
