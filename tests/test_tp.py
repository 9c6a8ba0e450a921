"""Barcode-axis tensor parallelism: the panel-sharded posterior over a
2-D (reads, panel) mesh must reproduce the single-device posterior."""

import jax
import numpy as np
import pytest

from pheniqs_tpu.device import classify as classify_mod
from pheniqs_tpu.device.instrument import UNIFORM_BASE_QUALITY, compile_instrument
from pheniqs_tpu.device.flagship import flagship_ontology, synthetic_batch
from pheniqs_tpu.device.tp import tp_mesh, tp_posterior


@pytest.fixture(scope="module")
def workload():
    ontology = flagship_ontology(sample_barcodes=16, cellular_barcodes=600)
    instrument = compile_instrument(ontology)
    batch = synthetic_batch(instrument, ontology, 512, seed=9)
    decoder = next(
        d for d in instrument.decoders if d.classifier_type == "cellular"
    )
    import jax.numpy as jnp

    code, qual, _length = batch["segments"][3]
    obs_code = jnp.asarray(code[:, :16])
    obs_qual = jnp.asarray(qual[:, :16])
    features = classify_mod.observation_features(instrument, obs_code, obs_qual)
    q_positive = (obs_qual > 0).astype(jnp.float32).sum(axis=1)
    return instrument, decoder, features, q_positive * UNIFORM_BASE_QUALITY


@pytest.mark.parametrize("reads_axis,panel_axis", [(2, 4), (1, 8), (4, 2)])
def test_tp_posterior_matches_single_device(workload, reads_axis, panel_axis):
    if len(jax.devices()) < reads_axis * panel_axis:
        pytest.skip("needs the virtual 8-device mesh")
    instrument, decoder, features, qpos = workload
    adjusted_noise = float(
        decoder.noise * decoder.random_barcode_probability
    )

    import jax.numpy as jnp

    # single-device reference (the monolithic posterior algebra)
    sigma = (
        jnp.dot(
            features,
            decoder.likelihood_matrix,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        + qpos[:, None]
    )
    shift = sigma.min(axis=1, keepdims=True)
    conditional = jnp.exp(
        classify_mod.LN_PHRED_BASE * (sigma - shift)
    )
    prior = conditional * decoder.concentration[None, :]
    ref_total = prior.sum(axis=1) + jnp.exp(
        float(np.log(adjusted_noise))
        - classify_mod.LN_PHRED_BASE * shift[:, 0]
    )
    ref_best_p = prior.max(axis=1)
    ref_best0 = jnp.argmax(prior, axis=1)
    ref_sigma_best = jnp.take_along_axis(
        sigma, ref_best0[:, None], axis=1
    )[:, 0]

    mesh = tp_mesh(reads_axis, panel_axis)
    best0, best_p, sigma_p, sigma_best, second_p = tp_posterior(
        mesh,
        features,
        qpos,
        decoder.likelihood_matrix,
        decoder.concentration,
        adjusted_noise,
    )

    # f32 matmul blocking differs between the sharded and monolithic
    # shapes (XLA picks different accumulation tilings), so float outputs
    # agree to ~1e-4 relative; decisions must agree exactly
    np.testing.assert_array_equal(np.asarray(best0), np.asarray(ref_best0))
    np.testing.assert_allclose(
        np.asarray(best_p), np.asarray(ref_best_p), rtol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(sigma_p), np.asarray(ref_total), rtol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(sigma_best), np.asarray(ref_sigma_best),
        rtol=1e-3, atol=1e-3,
    )
    # runner-up must be the true global second best
    prior_np = np.asarray(prior)
    part = np.partition(prior_np, -2, axis=1)
    np.testing.assert_allclose(
        np.asarray(second_p), part[:, -2], rtol=1e-3, atol=1e-30
    )


def test_tp_engine_decisions_match_default(tmp_path):
    """PHENIQS_TP engine (2-D mesh, panel-sharded PAMLD) must produce the
    same classified SAM as the default data-parallel engine."""
    import json
    import os
    import subprocess
    import sys

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")

    from pheniqs_tpu.benchmark import synthesize_fastq_input

    paths = synthesize_fastq_input(str(tmp_path / "input"), 40000)
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["1::"]}},
        "output": ["PLACEHOLDER"],
    }
    from pheniqs_tpu.device.flagship import flagship_ontology

    base = flagship_ontology()
    config["sample"] = base["sample"]
    config["cellular"] = base["cellular"]
    config["molecular"] = base["molecular"]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outputs = {}
    for label, extra in (
        ("default", {}),
        ("tp", {"PHENIQS_TP": "2:4", "PHENIQS_TP_THRESHOLD": "128"}),
    ):
        job = dict(config)
        out = tmp_path / f"out_{label}.sam"
        job["output"] = [str(out)]
        config_path = tmp_path / f"job_{label}.json"
        config_path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env.update(extra)
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", str(config_path), "--fidelity", "fast",
             "--threads", "2", "--batch-size", "8192"],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, (label, result.stderr[-2000:])
        outputs[label] = [
            # compare decisions (drop float tags: f32 merge noise)
            tuple(
                field
                for field in line.split("\t")
                if field[:5] not in ("XB:f:", "XM:f:", "XC:f:")
            )
            for line in out.read_text().splitlines()
            if not line.startswith("@")
        ]
    assert len(outputs["default"]) == len(outputs["tp"])
    mismatches = sum(
        1 for a, b in zip(outputs["default"], outputs["tp"]) if a != b
    )
    # f32 matmul blocking noise may flip reads that sit exactly on a
    # filter threshold; require essentially identical decisions
    assert mismatches <= len(outputs["tp"]) // 10000, mismatches


def test_tp_hybrid_decisions_match_strict(tmp_path):
    """PHENIQS_TP + --fidelity hybrid must still deliver strict-identical
    decisions (the derived-bound re-resolution covers the panel-sharded
    posterior's collective rounding too)."""
    import json
    import os
    import subprocess
    import sys

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")

    from pheniqs_tpu.benchmark import synthesize_fastq_input
    from pheniqs_tpu.device.flagship import flagship_ontology

    paths = synthesize_fastq_input(str(tmp_path / "input"), 20000)
    base = flagship_ontology(sample_barcodes=24, cellular_barcodes=300)
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["1::"]}},
        "sample": base["sample"],
        "cellular": base["cellular"],
        "molecular": base["molecular"],
    }
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outputs = {}
    for label, fidelity, extra in (
        ("strict", "strict", {}),
        ("tp_hybrid", "hybrid",
         {"PHENIQS_TP": "2:4", "PHENIQS_TP_THRESHOLD": "64"}),
    ):
        job = dict(config)
        out = tmp_path / f"out_{label}.sam"
        job["output"] = [str(out)]
        config_path = tmp_path / f"job_{label}.json"
        config_path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env.update(extra)
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", str(config_path), "--fidelity", fidelity,
             "--threads", "2", "--batch-size", "8192"],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, (label, result.stderr[-2000:])
        outputs[label] = [
            tuple(
                field for field in line.split("\t")
                if field[:5] not in ("XB:f:", "XM:f:", "XC:f:")
            )
            for line in out.read_text().splitlines()
            if not line.startswith("@")
        ]
    assert outputs["strict"] == outputs["tp_hybrid"]
