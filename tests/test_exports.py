"""Package-surface consistency: every lazy export resolves, api.__all__
and the lazy map agree (guards the round-2 advisor finding class: new
api functions must land in BOTH)."""

import importlib

import overiva_jax


def test_every_lazy_export_resolves():
    for name in overiva_jax._API:
        obj = getattr(overiva_jax, name)
        assert obj is not None, name


def test_api_all_covered_by_lazy_map():
    api = importlib.import_module("overiva_jax.api")
    missing = [n for n in api.__all__ if n not in overiva_jax._API]
    # frontend helpers intentionally exposed only via overiva_jax.api
    allowed = {"pca"}
    assert set(missing) <= allowed, f"api.__all__ names missing from lazy map: {missing}"


def test_unknown_attribute_raises():
    import pytest

    with pytest.raises(AttributeError):
        overiva_jax.definitely_not_a_thing
