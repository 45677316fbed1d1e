"""The port's capacity estimator against the JAX package's: the calibrated,
native and measured cost models give the same geometries, the measured
shapes are the same circuits' shapes, and the emitted geometry module is
the JAX text but for the package it imports from. Host code only."""

import dataclasses

import pytest

from zkevm_harness_tpu.circuits import capacity as jcap
from zkevm_harness_tpu_torch.circuits import capacity as tcap


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("models", ["calibrated_cost_models",
                                    "native_cost_models"])
def test_model_geometry_equals_jax(models):
    got = tcap.generate_geometry_config(getattr(tcap, models)())
    want = jcap.generate_geometry_config(getattr(jcap, models)())
    assert _fields(got) == _fields(want)


def test_cost_models_equal_jax():
    t, j = tcap.native_cost_models(), jcap.native_cost_models()
    assert t.keys() == j.keys()
    for name in t:
        assert (t[name].fixed_rows, t[name].rows_per_cycle) == \
            (j[name].fixed_rows, j[name].rows_per_cycle)


@pytest.mark.parametrize("capacity", [1, 4, 300])
def test_measured_shapes_equal_jax(capacity):
    t, j = tcap.measured_shape_fns(), jcap.measured_shape_fns()
    assert t.keys() == j.keys()
    for name in t:
        assert tuple(t[name](capacity)) == tuple(j[name](capacity)), name


def test_measured_geometry_equals_jax():
    assert _fields(tcap.measured_geometry()) == \
        _fields(jcap.measured_geometry())


def test_binary_search_equals_jax():
    for rows_for in (lambda c: 100 * c, lambda c: c, lambda c: 7 * c + 1000):
        assert tcap.binary_search_capacity(rows_for) == \
            jcap.binary_search_capacity(rows_for)


def test_emitted_module_is_the_jax_text_but_the_package():
    cfg = tcap.generate_geometry_config(tcap.calibrated_cost_models())
    got = tcap.emit_geometry_module(cfg)
    want = jcap.emit_geometry_module(
        jcap.generate_geometry_config(jcap.calibrated_cost_models()))
    assert got == want.replace("from zkevm_harness_tpu.circuits.types",
                               "from zkevm_harness_tpu_torch.circuits.types")
    assert got != want
    ns = {}
    exec(got, ns)
    assert ns["GEOMETRY"] == cfg
