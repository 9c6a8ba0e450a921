"""Companion tools vs the reference goldens (reference test/api/*)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(module, args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_prior_api_golden(reference_root):
    base = os.path.join(reference_root, "test/api/prior")
    result = run_tool(
        "pheniqs_tpu.tools.prior",
        [
            "--configuration", "BDGGG_annotated.json",
            "--report", "BDGGG_annotated_report.json",
        ],
        cwd=base,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    golden = open(
        os.path.join(base, "valid/BDGGG_annotated_estimated.json")
    ).read()
    assert result.stdout == golden


def test_io_api_golden(reference_root):
    base = os.path.join(reference_root, "test/api/io")
    result = run_tool(
        "pheniqs_tpu.tools.io",
        [
            "--configuration", "H7LT2DSXX_l01_sample.json",
            "-L", "-S", "--format", "fastq",
        ],
        cwd=base,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    golden = open(
        os.path.join(base, "valid/H7LT2DSXX_l01_sample_split.json")
    ).read()
    assert result.stdout == golden


@pytest.fixture(scope="module")
def illumina_results(reference_root, tmp_path_factory):
    """Run all five illumina actions from a test-shaped working directory."""
    base = tmp_path_factory.mktemp("illumina")
    os.symlink(
        os.path.join(
            reference_root, "test/api/illumina/181014_A00534_0024_AH7LT2DSXX"
        ),
        base / "181014_A00534_0024_AH7LT2DSXX",
    )
    workdir = base / "result"
    workdir.mkdir()
    for action in ("basecall", "core", "sample", "estimate", "interleave"):
        result = run_tool(
            "pheniqs_tpu.tools.illumina",
            [action, "../181014_A00534_0024_AH7LT2DSXX"],
            cwd=str(workdir),
        )
        assert result.returncode == 0, (action, result.stderr[-2000:])
    return workdir


def test_illumina_api_goldens(reference_root, illumina_results):
    valid = os.path.join(reference_root, "test/api/illumina/valid")
    for name in sorted(os.listdir(valid)):
        golden = open(os.path.join(valid, name)).read()
        generated = open(os.path.join(illumina_results, name)).read()
        assert generated == golden, f"{name} differs from golden"


def test_configuration_zsh_deterministic():
    from pheniqs_tpu.tools.configuration import generate_zsh

    first = generate_zsh()
    second = generate_zsh()
    assert first == second
    assert first.startswith("#compdef pheniqs-tpu")
    assert "_pheniqs_tpu_mux" in first
    assert "--fidelity" in first
