"""Mixed-format output jobs: a config routing
channels to DIFFERENT container formats in one run must give every
format group its own columnar render pass — byte/content-identical to
running each format alone — instead of dropping the whole render onto
the per-read Python fallback (the ~6x CRAM-intake cliff)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_mux(cwd, config_path, tmp, threads=1):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [
            sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
            "--config", config_path,
            "--base-output", str(tmp),
            "--precision", "15",
            "--threads", str(threads),
            "--report", "/dev/null",
        ],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
    )


def _config(base, outputs_by_barcode, undetermined_output):
    """BDGGG sample-only demux with per-channel outputs."""
    barcodes = ["AGGCAGAA", "CGTACTAG", "GGACTCCT", "TAAGGCGA", "TCCTGAGC"]
    codec = {}
    for barcode in barcodes:
        entry = {"barcode": [barcode]}
        if barcode in outputs_by_barcode:
            entry["output"] = [outputs_by_barcode[barcode]]
        codec[f"@{barcode}"] = entry
    return {
        "base input url": f"{base}/test/BDGGG",
        "input": ["BDGGG_s01.fastq", "BDGGG_s02.fastq", "BDGGG_s03.fastq"],
        "template": {"transform": {"token": ["0::", "2::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": 0.95,
            "noise": 0.05,
            "transform": {"token": ["1::8"]},
            "codec": codec,
            "undetermined": {"output": [undetermined_output]},
        },
    }


def _sam_records(path):
    return [
        line for line in open(path) if line.strip() and line[0] != "@"
    ]


def _cram_records(path):
    from pheniqs_tpu.io.cram import read_cram
    from pheniqs_tpu.iupac import BAM_TO_ASCII

    out = []
    for rec in read_cram(path):
        out.append(
            (
                rec.name,
                BAM_TO_ASCII[rec.code].tobytes(),
                rec.quality.tobytes(),
                rec.flag,
                tuple(sorted(rec.tags)) if hasattr(rec, "tags") else None,
            )
        )
    return out


@pytest.mark.parametrize("threads", [1, 3])
def test_mixed_sam_cram_outputs_match_single_format_runs(
    reference_root, tmp_path, threads
):
    mixed_dir = tmp_path / "mixed"
    sam_dir = tmp_path / "all_sam"
    cram_dir = tmp_path / "all_cram"
    for d in (mixed_dir, sam_dir, cram_dir):
        d.mkdir()

    mixed = _config(
        reference_root,
        {
            "AGGCAGAA": "a.sam",
            "CGTACTAG": "b.cram",
            "GGACTCCT": "a.sam",
            "TAAGGCGA": "b.cram",
            "TCCTGAGC": "a.sam",
        },
        "/dev/null",
    )
    all_sam = _config(
        reference_root,
        {
            "AGGCAGAA": "a.sam",
            "CGTACTAG": "x.sam",
            "GGACTCCT": "a.sam",
            "TAAGGCGA": "x.sam",
            "TCCTGAGC": "a.sam",
        },
        "/dev/null",
    )
    all_cram = _config(
        reference_root,
        {
            "AGGCAGAA": "y.cram",
            "CGTACTAG": "b.cram",
            "GGACTCCT": "y.cram",
            "TAAGGCGA": "b.cram",
            "TCCTGAGC": "y.cram",
        },
        "/dev/null",
    )
    for directory, config in (
        (mixed_dir, mixed), (sam_dir, all_sam), (cram_dir, all_cram)
    ):
        path = directory / "job.json"
        path.write_text(json.dumps(config))
        result = _run_mux(reference_root, str(path), directory, threads)
        assert result.returncode == 0, result.stderr[-2000:]

    # the sam side of the mixed job == the all-sam run's matching feed
    assert _sam_records(mixed_dir / "a.sam") == _sam_records(
        sam_dir / "a.sam"
    )
    # the cram side of the mixed job == the all-cram run's matching feed
    assert _cram_records(str(mixed_dir / "b.cram")) == _cram_records(
        str(cram_dir / "b.cram")
    )
    assert len(_sam_records(mixed_dir / "a.sam")) > 0
    assert len(_cram_records(str(mixed_dir / "b.cram"))) > 0


def test_mixed_job_takes_columnar_routes(reference_root, tmp_path):
    """The render plan gives each format a columnar pass (no feed left
    on the per-read fallback) for a sam+cram mix."""
    import numpy as np

    from pheniqs_tpu.cli.interface import Interface
    from pheniqs_tpu.config.compiler import InstructionCompiler
    from pheniqs_tpu.engine.strict import StrictEngine

    config = _config(
        reference_root,
        {
            "AGGCAGAA": "a.sam",
            "CGTACTAG": "b.cram",
            "GGACTCCT": "a.sam",
            "TAAGGCGA": "b.cram",
            "TCCTGAGC": "a.sam",
        },
        "/dev/null",
    )
    path = tmp_path / "job.json"
    path.write_text(json.dumps(config))
    cwd = os.getcwd()
    os.chdir(reference_root)
    try:
        interface = Interface(
            ["pheniqs", "mux", "--config", str(path),
             "--base-output", str(tmp_path)]
        )
        compiler = InstructionCompiler(interface.operation())
        compiler.assemble()
        ontology = compiler.compile()
        engine = StrictEngine(ontology)
        engine._initiate_feeds()
        try:
            plan, fallback = engine._render_plan()
            modes = sorted(mode for mode, _ in plan)
            assert modes == ["cram", "sam"], (plan, fallback)
            assert fallback is None
        finally:
            engine._close_feeds()
    finally:
        os.chdir(cwd)
