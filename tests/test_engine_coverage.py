"""Cross-engine coverage: MDD demux parity, QC under the multiprocess
engine, and a large-panel (chunked posterior) end-to-end run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "ACGT"


def run_mux(cwd, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux", *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )


def write_reads(path, panel, n, seed, error_rate=0.08):
    rng = np.random.default_rng(seed)
    with open(path, "w") as stream:
        for i in range(n):
            word = list(panel[rng.integers(len(panel))])
            quality = rng.integers(15, 41, size=len(word))
            for position in range(len(word)):
                if rng.random() < error_rate:
                    word[position] = BASES[rng.integers(4)]
                    quality[position] = rng.integers(2, 20)
            qual = "".join(chr(q + 33) for q in quality)
            stream.write(f"@r{i}\n{''.join(word)}\n+\n{qual}\n")


@pytest.fixture(scope="module")
def mdd_job(tmp_path_factory):
    base = tmp_path_factory.mktemp("mdd")
    rng = np.random.default_rng(17)
    panel = []
    while len(panel) < 8:
        word = "".join(rng.choice(list(BASES), size=10))
        if word not in panel:
            panel.append(word)
    write_reads(base / "reads.fastq", panel, 3000, seed=2)
    config = {
        "input": [str(base / "reads.fastq")],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "mdd",
            "distance tolerance": [2],
            "transform": {"token": ["0::10"]},
            "codec": {f"@{w}": {"barcode": [w]} for w in panel},
        },
    }
    return base, config


def run_job(base, config, name, extra=()):
    job = dict(config)
    out = base / f"{name}.sam"
    job["output"] = [str(out)]
    path = base / f"{name}.json"
    path.write_text(json.dumps(job))
    result = run_mux(
        str(base), ["--config", str(path), "--precision", "15", *extra]
    )
    assert result.returncode == 0, result.stderr[-3000:]
    return out.read_text(), result.stderr


def body(text):
    return [l for l in text.split("\n") if l and not l.startswith("@")]


def test_mdd_demux_fast_matches_strict(mdd_job):
    base, config = mdd_job
    strict, _ = run_job(base, config, "mdd_strict")
    fast, _ = run_job(base, config, "mdd_fast", ("--fidelity", "fast"))
    assert body(strict) == body(fast)  # MDD is integer-exact on device


def test_quality_report_parallel_matches_serial(mdd_job):
    base, config = mdd_job
    _, serial_report = run_job(base, config, "qc_serial", ("--quality",))
    _, parallel_report = run_job(
        base, config, "qc_parallel",
        ("--quality", "--threads", "3", "--decoding-threads", "3"),
    )
    serial = json.loads(serial_report)
    parallel = json.loads(parallel_report)
    assert serial["multiplex"] == parallel["multiplex"]


def test_large_panel_engine_end_to_end(tmp_path):
    """A 1500-barcode cellular panel routes through the chunked online
    posterior inside the fast engine; decisions must match strict."""
    rng = np.random.default_rng(3)
    panel = set()
    while len(panel) < 1500:
        panel.add("".join(rng.choice(list(BASES), size=12)))
    panel = sorted(panel)
    write_reads(tmp_path / "reads.fastq", panel, 600, seed=4, error_rate=0.03)
    config = {
        "input": [str(tmp_path / "reads.fastq")],
        "template": {"transform": {"token": ["0::"]}},
        "cellular": [
            {
                "algorithm": "pamld",
                "confidence threshold": 0.9,
                "noise": 0.05,
                "transform": {"token": ["0::12"]},
                "codec": {f"@{w}": {"barcode": [w]} for w in panel},
            }
        ],
    }
    strict, _ = run_job(tmp_path, config, "large_strict")
    fast, _ = run_job(tmp_path, config, "large_fast", ("--fidelity", "hybrid"))
    strict_tags = [
        [f for f in line.split("\t") if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")]
        for line in body(strict)
    ]
    fast_tags = [
        [f for f in line.split("\t") if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")]
        for line in body(fast)
    ]
    assert strict_tags == fast_tags


def test_split_library_fastq_outputs(reference_root, tmp_path):
    """Per-barcode split fastq.gz output (the production layout tools/io
    generates): every channel file holds exactly its classified reads."""
    import gzip

    config = {
        "import": [
            os.path.join(reference_root, "test/BDGGG/BDGGG_annotated.json")
        ],
        "base input url": os.path.join(reference_root, "test/BDGGG"),
        "report url": "/dev/stderr",
        "sample": {
            "base": "BDGGG_sample",
            "algorithm": "pamld",
            "undetermined": {
                "output": [str(tmp_path / "undetermined.fastq.gz")]
            },
            "codec": {
                f"@{w}": {"output": [str(tmp_path / f"{w}.fastq.gz")]}
                for w in (
                    "AGGCAGAA", "CGTACTAG", "GGACTCCT", "TAAGGCGA", "TCCTGAGC"
                )
            },
        },
        "template": {"transform": {"token": ["0::"]}},
    }
    path = tmp_path / "split.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-3000:]
    report = json.loads(result.stderr)

    def fastq_count(name):
        target = tmp_path / name
        if not target.exists():
            return 0
        with gzip.open(target, "rt") as stream:
            return sum(1 for _ in stream) // 4

    classified = {
        "".join(entry["barcode"]): entry["count"]
        for entry in report["sample"]["classified"]
    }
    for word, count in classified.items():
        assert fastq_count(f"{word}.fastq.gz") == count, word
    assert fastq_count("undetermined.fastq.gz") == report["sample"][
        "unclassified"
    ]["count"]


def test_three_segment_output_fi_tc_tags(reference_root, tmp_path):
    """Output cardinality > 2 emits FI/TC per segment (reference
    auxiliary.cpp:327-333) and RG inference skips null flowcell fields."""
    base = os.path.join(reference_root, "test/BDGGG")
    config = {
        "input": [
            os.path.join(base, f"BDGGG_s0{i}.fastq") for i in (1, 2, 3)
        ],
        "output": [str(tmp_path / "out.sam")],
        "template": {"transform": {"token": ["0::", "1::", "2::"]}},
    }
    path = tmp_path / "tc3.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-2000:]
    lines = body((tmp_path / "out.sam").read_text())
    assert len(lines) == 750
    for index, line in enumerate(lines[:6]):
        fields = line.split("\t")
        assert f"FI:i:{index % 3 + 1}" in fields
        assert "TC:i:3" in fields
        assert "RG:Z:undetermined" in fields  # no None:None prefix


# --- sensed-input mid-stream sync verification (round 2) -------------------
# The reference verifies all feeds stay in agreement past the sensing
# window (reference transcode.cpp:559-682); a feed whose interleave
# pattern diverges mid-stream must fail typed, not silently miscount.


def _write_interleaved(path, n_pairs, diverge_at=None):
    with open(path, "w") as stream:
        for i in range(n_pairs):
            for segment in range(2):
                name = f"pair{i}"
                if diverge_at is not None and i == diverge_at and segment == 1:
                    name = f"rogue{i}"  # breaks the sensed resolution-2 pattern
                stream.write(f"@{name} {segment+1}:N:0:AA\nACGTACGT\n+\nIIIIIIII\n")


@pytest.mark.parametrize("native_path", [True, False])
def test_sensed_interleave_divergence_fails_typed(tmp_path, native_path, monkeypatch):
    import json as json_mod
    import subprocess
    import sys as sys_mod

    path = tmp_path / "interleaved.fastq"
    # diverge far past the sensing window (first records)
    _write_interleaved(path, 600, diverge_at=500)
    config = {
        "input": [str(path)],
        "sense input layout": True,
        "template": {"transform": {"token": ["0::", "1::"]}},
        "output": [str(tmp_path / "out.sam")],
    }
    config_path = tmp_path / "job.json"
    config_path.write_text(json_mod.dumps(config))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    if not native_path:
        env["PHENIQS_NATIVE"] = "0"
    result = subprocess.run(
        [sys_mod.executable, "-m", "pheniqs_tpu.cli.main", "mux",
         "--config", str(config_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 7, (result.returncode, result.stderr[-500:])
    assert "out of sync" in result.stderr
    # the error must implicate the head-probe sensing and name the
    # per-feed resolution so the user knows what to override
    assert "sensed" in result.stderr, result.stderr[-500:]
    assert "feed resolution" in result.stderr, result.stderr[-500:]


def test_worker_error_relays_typed(tmp_path):
    """A typed failure inside a streamed worker (here: corrupt FASTQ parsed
    by an autonomous strict worker) must surface as the same typed error
    and exit code as the serial engine, not a generic worker crash."""
    path = tmp_path / "bad.fastq"
    good = "".join(f"@r{i}\nACGTACGT\n+\nIIIIIIII\n" for i in range(2000))
    path.write_text(good + "JUNK-NOT-A-HEADER\nACGT\n+\nIIII\n")
    config = {
        "input": [str(path)],
        "template": {"transform": {"token": ["0::"]}},
        "output": [str(tmp_path / "out.sam")],
    }
    config_path = tmp_path / "job.json"
    config_path.write_text(json.dumps(config))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["PHENIQS_STREAM_TRANSPORT"] = "autonomous"
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
         "--config", str(config_path), "--threads", "3",
         "--batch-size", "256"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 7, (result.returncode, result.stderr[-500:])
    assert "corrupt FASTQ" in result.stderr
