"""Stable-key AOT program store (device/aot.py) and compile-cache placement.

The XLA persistent compile cache keys on HLO source-line metadata, so
unrelated source edits re-pay the cold compile. These tests pin the
semantic-key properties (stable across re-traces, sensitive to
computation/constant changes), the artifact round trip (second build
loads from disk and computes identical results), and where both caches
live (JAX_COMPILATION_CACHE_DIR, else the checkout's .jax_cache).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pheniqs_tpu.device.aot import aot_jit, semantic_key


def _make_fn(scale: float):
    const = jnp.arange(12.0).reshape(3, 4) * scale

    def fn(batch):
        x = batch["blob"].astype(jnp.float32)
        return {"out": x @ const, "total": x.sum()}

    return fn


SPECS = {"blob": jax.ShapeDtypeStruct((5, 3), jnp.uint8)}


def test_semantic_key_stable_across_retraces():
    assert semantic_key(_make_fn(1.0), SPECS) == semantic_key(
        _make_fn(1.0), SPECS
    )


def test_semantic_key_sensitive_to_constants_shapes_and_ops():
    base = semantic_key(_make_fn(1.0), SPECS)
    assert semantic_key(_make_fn(2.0), SPECS) != base  # constant changed
    other = {"blob": jax.ShapeDtypeStruct((6, 3), jnp.uint8)}
    assert semantic_key(_make_fn(1.0), other) != base  # shape changed

    def different(batch):
        x = batch["blob"].astype(jnp.float32)
        return {"out": x @ (jnp.arange(12.0).reshape(3, 4)), "total": x.max()}

    assert semantic_key(different, SPECS) != base  # op changed


def test_artifact_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("PHENIQS_AOT", str(tmp_path))
    x = {"blob": jnp.asarray(np.arange(15, dtype=np.uint8).reshape(5, 3))}
    expected = jax.jit(_make_fn(1.0))(x)

    first = aot_jit(_make_fn(1.0), SPECS, label="t")
    got = first(x)
    np.testing.assert_allclose(got["out"], expected["out"])
    artifacts = [p for p in os.listdir(tmp_path) if p.endswith(".jaxexport")]
    assert len(artifacts) == 1

    # second build must come from disk: exporting again would crash here
    import pheniqs_tpu.device.aot as aot_module

    class Boom:
        def __getattr__(self, name):
            raise AssertionError("export path used despite cached artifact")

    real_export = jax.export.export
    monkeypatch.setattr(jax.export, "export", Boom())
    try:
        second = aot_jit(_make_fn(1.0), SPECS, label="t")
    finally:
        monkeypatch.setattr(jax.export, "export", real_export)
    got2 = second(x)
    np.testing.assert_allclose(got2["out"], expected["out"])
    assert float(got2["total"]) == float(expected["total"])


def test_disabled_falls_back_to_jit(monkeypatch):
    monkeypatch.setenv("PHENIQS_AOT", "0")
    x = {"blob": jnp.ones((5, 3), jnp.uint8)}
    step = aot_jit(_make_fn(1.0), SPECS, label="t")
    np.testing.assert_allclose(
        step(x)["out"], jax.jit(_make_fn(1.0))(x)["out"]
    )


def test_cpu_backend_store_off_by_default(monkeypatch, tmp_path):
    """On the CPU backend with no explicit PHENIQS_AOT, aot_jit must not
    export or load artifacts: loading an XLA:CPU AOT artifact prints the
    cpu_aot_loader machine-feature SIGILL warning even same-host (baked
    LLVM tuning attrs vs raw cpuinfo)."""
    monkeypatch.delenv("PHENIQS_AOT", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax.default_backend() == "cpu"
    x = {"blob": jnp.ones((5, 3), jnp.uint8)}
    step = aot_jit(_make_fn(1.0), SPECS, label="t")
    np.testing.assert_allclose(
        step(x)["out"], jax.jit(_make_fn(1.0))(x)["out"]
    )
    aot_dir = tmp_path / "aot"
    assert not aot_dir.exists() or not list(aot_dir.iterdir())
    # explicit opt-in still engages the store on CPU
    monkeypatch.setenv("PHENIQS_AOT", str(tmp_path / "explicit"))
    aot_jit(_make_fn(1.0), SPECS, label="t")
    assert list((tmp_path / "explicit").iterdir())


def test_engine_decode_step_through_store(tmp_path, monkeypatch):
    """The real single-chip decode step exports, round-trips, and computes
    the same packed decisions as plain jit."""
    monkeypatch.setenv("PHENIQS_AOT", str(tmp_path))
    from pheniqs_tpu.device.flagship import (
        flagship_instrument,
        flagship_ontology,
        synthetic_batch,
    )
    from pheniqs_tpu.device.step import (
        h2d_blob_bytes,
        make_decode_step,
        pack_h2d_blob,
    )

    instrument = flagship_instrument()
    ontology = flagship_ontology()
    n = 256
    batch = synthetic_batch(instrument, ontology, n, seed=5)
    widths = [
        -(-max(code.shape[1], 1) // 4) * 4
        for code, _, _ in (
            batch["segments"][s] for s in instrument.used_segments
        )
    ]
    used = [batch["segments"][s] for s in instrument.used_segments]
    blob = pack_h2d_blob(
        widths,
        [(c.astype(np.uint8), q.astype(np.uint8), l) for c, q, l in used],
        batch["qcfail"],
    )
    fn = make_decode_step(
        instrument,
        want_uncertain=True,
        want_counters=True,
        pack_outputs=True,
        h2d_widths=widths,
    )
    specs = {
        "blob": jax.ShapeDtypeStruct((n, h2d_blob_bytes(widths)), jnp.uint8)
    }
    x = {"blob": jnp.asarray(blob)}
    packed_ref, counters_ref = jax.jit(fn)(x)

    step = aot_jit(fn, specs, label="decode")
    packed, counters = step(x)
    np.testing.assert_array_equal(packed["blob"], packed_ref["blob"])
    np.testing.assert_allclose(counters, counters_ref)

    step2 = aot_jit(fn, specs, label="decode")
    packed2, _ = step2(x)
    np.testing.assert_array_equal(packed2["blob"], packed_ref["blob"])


def test_semantic_key_sensitive_to_cpu_fingerprint(monkeypatch):
    """A different host CPU identity must force a recompile on the CPU
    backend (XLA:CPU artifacts bake model-derived LLVM tuning attributes
    like +prefer-no-gather that /proc/cpuinfo flags alone don't capture —
    the round-3 dryrun loaded a foreign artifact XLA warned may SIGILL)."""
    from pheniqs_tpu.device import aot

    base = semantic_key(_make_fn(1.0), SPECS)
    monkeypatch.setattr(
        aot, "cpu_fingerprint", lambda: "other-machine|model=99|flags"
    )
    assert semantic_key(_make_fn(1.0), SPECS) != base


def test_cpu_fingerprint_carries_model_identity():
    from pheniqs_tpu.device.aot import cpu_fingerprint

    value = cpu_fingerprint()
    arch, model, flags = value.split("|")
    assert arch  # platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        # on x86 both the model identity and the flag list must be there
        assert "=" in model or flags


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache settings after a test changes them."""
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
    )
    previous = {key: getattr(jax.config, key) for key in keys}
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    for key, value in previous.items():
        jax.config.update(key, value)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_compile_cache_env_set_means_code_sets_nothing(
    backend, cache_config, monkeypatch, tmp_path
):
    """Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself: the
    program sets no cache directory in code, on any backend."""
    from pheniqs_tpu.engine.device import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_unset_on_gpu_uses_checkout_path(
    cache_config, monkeypatch
):
    """Unset on the GPU: one fixed path inside the checkout, which
    .gitignore lists (a cache whose path moves never hits)."""
    from pheniqs_tpu.device.aot import CHECKOUT_CACHE
    from pheniqs_tpu.engine.device import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert CHECKOUT_CACHE == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as handle:
        assert ".jax_cache/" in handle.read().split()


def test_compile_cache_off_by_default_on_cpu(cache_config, monkeypatch):
    """The CPU backend is the test backend: even a same-host cache HIT
    prints the spurious cpu_aot_loader feature warning and CPU compiles
    take seconds, so with the variable unset the cache stays off."""
    from pheniqs_tpu.engine.device import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None


@pytest.mark.parametrize("env_set", [True, False])
def test_aot_store_lives_under_the_cache_root(env_set, monkeypatch, tmp_path):
    """The AOT store sits in ``aot`` under the same root as the XLA cache;
    PHENIQS_AOT=dir|0 overrides."""
    from pheniqs_tpu.device.aot import CHECKOUT_CACHE, aot_cache_dir

    monkeypatch.delenv("PHENIQS_AOT", raising=False)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert aot_cache_dir() == str(tmp_path / "aot")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert aot_cache_dir() == os.path.join(CHECKOUT_CACHE, "aot")
    monkeypatch.setenv("PHENIQS_AOT", "0")
    assert aot_cache_dir() is None
