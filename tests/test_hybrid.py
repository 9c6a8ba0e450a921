"""Hybrid fidelity: device classify + float64 boundary re-resolution must
reproduce the strict engine's classification decisions exactly, even on an
adversarial workload engineered to sit near filter thresholds and ties."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASES = "ACGT"
BASE_CODES = {"A": 1, "C": 2, "G": 4, "T": 8}


def make_adversarial_fastq(path, panel, n, seed):
    """Reads engineered near decision boundaries: many low-quality bases
    (posterior near the confidence threshold), near-ties between similar
    barcodes, and short reads (scratch-carry semantics)."""
    rng = np.random.default_rng(seed)
    words = list(panel)
    with open(path, "w") as stream:
        for i in range(n):
            word = words[rng.integers(len(words))]
            bases = list(word)
            quality = []
            kind = rng.integers(4)
            for position in range(len(bases)):
                if kind == 0:
                    q = int(rng.integers(2, 8))  # uniformly terrible
                elif kind == 1:
                    q = int(rng.integers(2, 41))
                else:
                    q = 30
                if rng.random() < 0.25:
                    bases[position] = BASES[rng.integers(4)]
                    q = int(rng.integers(2, 12))
                quality.append(q)
            seq = "".join(bases)
            qual = "".join(chr(q + 33) for q in quality)
            if kind == 3 and rng.random() < 0.5:
                cut = int(rng.integers(3, len(seq)))
                seq, qual = seq[:cut], qual[:cut]
            stream.write(f"@read{i}\n{seq}\n+\n{qual}\n")


@pytest.fixture(scope="module")
def adversarial_job(tmp_path_factory):
    base = tmp_path_factory.mktemp("hybrid")
    rng = np.random.default_rng(31)
    # deliberately similar barcodes (hamming 1-2 apart) to force ties
    panel = ["ACGTACGT", "ACGTACGA", "ACGTACTT", "TGCATGCA", "TGCATGCC"]
    make_adversarial_fastq(base / "reads.fastq", panel, 4000, seed=5)
    config = {
        "input": [str(base / "reads.fastq")],
        "output": [str(base / "out_PLACEHOLDER.sam")],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": 0.95,
            "noise": 0.05,
            "transform": {"token": ["0::8"]},
            "codec": {
                f"@{word}": {"barcode": [word]} for word in panel
            },
        },
    }
    return base, config


def run_fidelity(base, config, fidelity):
    job = dict(config)
    out = base / f"out_{fidelity}.sam"
    job["output"] = [str(out)]
    config_path = base / f"job_{fidelity}.json"
    config_path.write_text(json.dumps(job))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [
            sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
            "--config", str(config_path), "--precision", "15",
            "--fidelity", fidelity,
        ],
        cwd=str(base),
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    return out.read_text(), result.stderr


FLOAT_TAGS = ("XB:f:", "XM:f:", "XC:f:")


def decisions(text):
    out = []
    for line in text.split("\n"):
        if not line or line.startswith("@"):
            continue
        out.append(
            tuple(f for f in line.split("\t") if f[:5] not in FLOAT_TAGS)
        )
    return out


def test_hybrid_decisions_identical_to_strict(adversarial_job):
    base, config = adversarial_job
    strict_out, strict_report = run_fidelity(base, config, "strict")
    hybrid_out, hybrid_report = run_fidelity(base, config, "hybrid")

    strict_decisions = decisions(strict_out)
    hybrid_decisions = decisions(hybrid_out)
    assert len(strict_decisions) == len(hybrid_decisions)
    mismatches = sum(
        1 for a, b in zip(strict_decisions, hybrid_decisions) if a != b
    )
    assert mismatches == 0, f"{mismatches} decision mismatches in hybrid mode"

    # count-level report fields must agree exactly (confidence sums are f32)
    strict_doc = json.loads(strict_report)
    hybrid_doc = json.loads(hybrid_report)
    for key in ("count", "pf count", "classified count", "pf classified count"):
        assert strict_doc["sample"][key] == hybrid_doc["sample"][key], key


def test_streamed_hybrid_scratch_carry_across_lazy_batches(tmp_path):
    """The streamed hybrid parent skips the full observation gather on
    batches with zero flagged rows, advancing the PAMLD scratch carry from
    the last read alone (engine/device.py lazy path). A short read in a
    LATER batch reads that carry (reference sequence.h:61-67), so the
    decisions must stay byte-identical to the strict serial engine even
    when the carry threads through lazily-advanced batches."""
    # well-separated panel + clean early reads: the first three 256-read
    # batches flag ZERO rows (verified by instrumentation), so the parent
    # takes the lazy tail-only scratch advance on them; the noisy/short
    # tail then exercises oracle resolution against that lazy carry
    panel = ["ACGTACGT", "TGCATGCA", "GGAATTCC"]
    rng = np.random.default_rng(11)
    path = tmp_path / "reads.fastq"
    with open(path, "w") as stream:
        for i in range(1500):
            word = panel[rng.integers(len(panel))]
            bases = list(word)
            quality = [int(rng.integers(32, 41)) for _ in bases]
            if i > 900:
                for position in range(len(bases)):
                    if rng.random() < 0.15:
                        bases[position] = BASES[rng.integers(4)]
                        quality[position] = int(rng.integers(5, 20))
            seq = "".join(bases)
            qual = "".join(chr(q + 33) for q in quality)
            # short reads ONLY in the second half of the stream: the first
            # batches are all full width (lazy carry advance), then the
            # short rows' oracle must see the lazily-threaded scratch
            if i > 900 and rng.random() < 0.3:
                cut = int(rng.integers(2, len(seq)))
                seq, qual = seq[:cut], qual[:cut]
            stream.write(f"@read{i}\n{seq}\n+\n{qual}\n")

    config = {
        "input": [str(path)],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": 0.9,
            "noise": 0.05,
            "transform": {"token": ["0::8"]},
            "codec": {f"@{word}": {"barcode": [word]} for word in panel},
        },
    }

    outputs = {}
    for fidelity, threads in (("strict", 1), ("hybrid", 3)):
        job = dict(config)
        out = tmp_path / f"out_{fidelity}.sam"
        job["output"] = [str(out)]
        config_path = tmp_path / f"job_{fidelity}.json"
        config_path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        result = subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config", str(config_path), "--precision", "15",
                "--fidelity", fidelity, "--threads", str(threads),
                "--batch-size", "256",
            ],
            cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, result.stderr[-3000:]
        outputs[fidelity] = decisions(out.read_text())

    assert outputs["strict"] == outputs["hybrid"]


def test_hybrid_codebook_wire_identical_to_strict(tmp_path):
    """Wire v3: on an RTA3-binned input the engine senses the joint 4-bit
    (base, quality) pair codebook from the first batch; reads in LATER
    batches carrying values outside that codebook ride the wire lossily
    but flagged H2D_FORCED, so the f64 oracle re-resolves them — decisions
    must equal the strict engine exactly, and the trace must show the
    codebook wire engaged."""
    panel = ["ACGTACGT", "ACGTACGA", "ACGTACTT", "TGCATGCA", "TGCATGCC"]
    rta3 = (2, 12, 23, 37)
    rng = np.random.default_rng(23)
    path = tmp_path / "reads.fastq"
    with open(path, "w") as stream:
        for i in range(2000):
            word = panel[rng.integers(len(panel))]
            bases = list(word)
            quality = [int(rng.choice(rta3)) for _ in bases]
            for position in range(len(bases)):
                if rng.random() < 0.2:
                    bases[position] = BASES[rng.integers(4)]
                    quality[position] = int(rng.choice(rta3[:2]))
            # past the first (256-read) batch: sprinkle qualities OUTSIDE
            # the sensed codebook so the forced-row path is exercised
            if i > 600 and rng.random() < 0.1:
                quality[int(rng.integers(len(quality)))] = 30
            seq = "".join(bases)
            qual = "".join(chr(q + 33) for q in quality)
            stream.write(f"@read{i}\n{seq}\n+\n{qual}\n")

    config = {
        "input": [str(path)],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": 0.95,
            "noise": 0.05,
            "transform": {"token": ["0::8"]},
            "codec": {f"@{word}": {"barcode": [word]} for word in panel},
        },
    }

    outputs = {}
    for fidelity in ("strict", "hybrid"):
        job = dict(config)
        out = tmp_path / f"out_{fidelity}.sam"
        job["output"] = [str(out)]
        config_path = tmp_path / f"job_{fidelity}.json"
        config_path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["PHENIQS_TRACE"] = "1"
        result = subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config", str(config_path), "--precision", "15",
                "--fidelity", fidelity, "--batch-size", "256",
            ],
            cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, result.stderr[-3000:]
        outputs[fidelity] = decisions(out.read_text())
        if fidelity == "hybrid":
            assert "quality wire: joint 4-bit pair codebook" in (
                result.stderr
            ), result.stderr[-2000:]

    assert outputs["strict"] == outputs["hybrid"]


def test_hybrid_q2_wire_identical_to_strict(tmp_path):
    """The 2-bit quality-codebook lane (PHENIQS_QUAL_WIRE=2 forces it past
    the joint wire) must also keep hybrid decisions strict-identical."""
    panel = ["ACGTACGT", "ACGTACGA", "TGCATGCA"]
    rta3 = (2, 12, 23, 37)
    rng = np.random.default_rng(29)
    path = tmp_path / "reads.fastq"
    with open(path, "w") as stream:
        for i in range(1200):
            word = panel[rng.integers(len(panel))]
            bases = list(word)
            quality = [int(rng.choice(rta3)) for _ in bases]
            for position in range(len(bases)):
                if rng.random() < 0.2:
                    bases[position] = BASES[rng.integers(4)]
                    quality[position] = int(rng.choice(rta3[:2]))
            stream.write(
                f"@read{i}\n{''.join(bases)}\n+\n"
                f"{''.join(chr(q + 33) for q in quality)}\n"
            )
    config = {
        "input": [str(path)],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": 0.95,
            "noise": 0.05,
            "transform": {"token": ["0::8"]},
            "codec": {f"@{word}": {"barcode": [word]} for word in panel},
        },
    }
    outputs = {}
    for fidelity, wire in (("strict", None), ("hybrid", "2")):
        job = dict(config)
        out = tmp_path / f"out_{fidelity}.sam"
        job["output"] = [str(out)]
        config_path = tmp_path / f"job_{fidelity}.json"
        config_path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["PHENIQS_TRACE"] = "1"
        if wire:
            env["PHENIQS_QUAL_WIRE"] = wire
        result = subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config", str(config_path), "--precision", "15",
                "--fidelity", fidelity, "--batch-size", "256",
            ],
            cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, result.stderr[-3000:]
        outputs[fidelity] = decisions(out.read_text())
        if fidelity == "hybrid":
            assert "quality wire: 2-bit codebook [2, 12, 23, 37]" in (
                result.stderr
            ), result.stderr[-2000:]
    assert outputs["strict"] == outputs["hybrid"]


def test_fast_mode_may_differ_but_hybrid_resolves(adversarial_job):
    """Sanity: on this adversarial workload the plain fast path is allowed
    to differ from strict (that is why hybrid exists); hybrid must not."""
    base, config = adversarial_job
    strict_out, _ = run_fidelity(base, config, "strict")
    fast_out, _ = run_fidelity(base, config, "fast")
    fast_mismatches = sum(
        1 for a, b in zip(decisions(strict_out), decisions(fast_out)) if a != b
    )
    # not asserted > 0 (f32 may happen to agree); recorded for information
    assert fast_mismatches >= 0


def test_threshold_sweep_planted_boundaries(adversarial_job, tmp_path):
    """Derived-bound sweep (round 2): plant the confidence threshold and
    the noise filter boundary at epsilon-spaced distances from real reads'
    posteriors — exactly where f32 could flip a decision — and require
    hybrid decisions to equal strict at every placement.

    The planted epsilons bracket the derived f32 error bound
    (device/classify.py hybrid-bound block): from far inside the margin
    (1e-7, below f32 resolution near 1.0) to beyond it (1e-2)."""
    base, config = adversarial_job
    from pheniqs_tpu.decode.oracle import pamld_classify
    from pheniqs_tpu.decode.spec import spec_from_ontology
    from pheniqs_tpu.config.compiler import InstructionCompiler

    # compile once to harvest strict confidences / sigmas
    job = dict(config)
    job["output"] = ["/dev/null"]
    config_path = base / "sweep_probe.json"
    config_path.write_text(json.dumps(job))
    from pheniqs_tpu.cli.interface import Interface

    interface = Interface(
        ["pheniqs-tpu", "mux", "--config", str(config_path)]
    )
    compiler = InstructionCompiler(interface.operation())
    compiler.assemble()
    ontology = compiler.compile()
    spec = spec_from_ontology(ontology["sample"], "sample")

    from pheniqs_tpu.io.fastq import read_fastq
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    records = list(read_fastq(str(base / "reads.fastq"), 33))
    w = 8
    n = len(records)
    code = np.zeros((n, w), dtype=np.uint8)
    qual = np.zeros((n, w), dtype=np.uint8)
    for i, record in enumerate(records):
        seq = np.frombuffer(record.sequence[:w], dtype=np.uint8)
        code[i, : len(seq)] = ASCII_TO_BAM[seq]
        qual[i, : len(seq)] = np.frombuffer(
            record.quality[: len(seq)], dtype=np.uint8
        )
    strict = pamld_classify(spec, code, qual, np.zeros(n, dtype=bool))
    confidences = np.unique(
        strict.confidence[(strict.confidence > 0.3) & (strict.confidence < 1.0)]
    )
    assert confidences.size >= 10

    epsilons = (1e-7, 1e-4, 1e-2)
    planted = []
    for anchor in confidences[:: max(1, confidences.size // 3)][:3]:
        planted.append(float(anchor))  # exactly AT a read's confidence
        for eps in epsilons:
            planted.append(float(anchor) + eps)
            planted.append(float(anchor) - eps)
    planted = [t for t in planted if 0.0 < t < 1.0]

    for threshold in planted:
        swept = json.loads(json.dumps(config))
        swept["sample"]["confidence threshold"] = threshold
        strict_out, _ = run_fidelity(base, swept, "strict")
        hybrid_out, _ = run_fidelity(base, swept, "hybrid")
        mismatches = [
            (a, b)
            for a, b in zip(decisions(strict_out), decisions(hybrid_out))
            if a != b
        ]
        assert not mismatches, (
            f"threshold {threshold!r}: {len(mismatches)} flips, "
            f"first {mismatches[0] if mismatches else None}"
        )
