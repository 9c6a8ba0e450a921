"""North-star vignette workloads: drive the real
reference vignette configurations end-to-end on synthetic reads drawn from
their own barcode panels — dual-index Illumina sample demux, sci-RNA-seq
combinatorial cellular + UMI, SPLiT-seq multi-round + prior estimation.
Strict and hybrid decisions must agree; reports must classify the bulk of
the reads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "ACGT"


def run_mux(cwd, args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


def compile_config(directory, name, inputs):
    args = ["--config", name, "--compile", "--precision", "15"]
    for url in inputs:
        args += ["-i", url]
    result = run_mux(directory, args)
    assert result.returncode == 0, result.stderr[-2000:]
    return json.loads(result.stdout)


def synthesize(compiled, paths, n, seed, error_rate=0.02):
    """Write synthetic FASTQ feeds matching the compiled instruction:
    reads carry panel barcodes at every decoder token extent."""
    rng = np.random.default_rng(seed)
    cardinality = compiled["input segment cardinality"]
    # minimum width per segment: max fixed token end over all decoders + 10
    widths = [30] * cardinality
    writes = []  # (segment, start, end, panel list[str], offset, revcomp)
    complement = str.maketrans("ACGTN", "TGCAN")
    for topic in ("sample", "cellular", "molecular"):
        node = compiled.get(topic)
        decoders = node if isinstance(node, list) else ([node] if node else [])
        for decoder in decoders:
            transform = decoder.get("transform")
            if not transform:
                continue
            tokens = transform["token"]
            knit = transform.get("knit") or [str(i) for i in range(len(tokens))]
            codec = decoder.get("codec")
            words = None
            if codec:
                words = [
                    "".join(entry["barcode"]) for entry in codec.values()
                ]
            # observation composition follows knit order, honoring '~'
            offset = 0
            for pattern in knit:
                for piece in pattern.split(":"):
                    revcomp = piece.startswith("~")
                    token = tokens[int(piece.lstrip("~"))]
                    segment_text, start_text, end_text = token.split(":")
                    segment = int(segment_text)
                    start = int(start_text) if start_text else 0
                    end = int(end_text)
                    widths[segment] = max(widths[segment], end + 4)
                    writes.append((segment, start, end, words, offset, revcomp))
                    offset += end - start

    assignments = []  # per decoder-with-codec: chosen word index per read
    streams = [open(path, "w") for path in paths]
    try:
        for i in range(n):
            segments = [
                [BASES[b] for b in rng.integers(4, size=widths[s])]
                for s in range(cardinality)
            ]
            chosen = {}
            for segment, start, end, words, offset, revcomp in writes:
                if words is None:
                    continue
                key = id(words)
                if key not in chosen:
                    chosen[key] = words[rng.integers(len(words))]
                word = chosen[key][offset : offset + (end - start)]
                if revcomp:
                    # the decoder reverse-complements this slice, so write
                    # the reverse complement of the barcode piece
                    word = word.translate(complement)[::-1]
                for p, base in enumerate(word):
                    if rng.random() >= error_rate:
                        segments[segment][start + p] = base
            for s in range(cardinality):
                seq = "".join(segments[s])
                qual = "".join(
                    chr(int(q) + 33) for q in rng.integers(25, 41, size=widths[s])
                )
                streams[s].write(f"@v{i} {s + 1}:N:0:\n{seq}\n+\n{qual}\n")
    finally:
        for stream in streams:
            stream.close()


def decisions(path):
    return [
        [
            f
            for f in line.rstrip("\n").split("\t")
            if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")
        ]
        for line in open(path)
        if line.strip() and not line.startswith("@")
    ]


VIGNETTES = [
    ("example/illumina_vignette", "H7LT2DSXX_l01_sample.json", 4),
    ("example/scirnaseq_vignette", "HGGKLBGX2_l01_cellular.json", None),
    ("example/splitseq_vignette", "splitseq_l01_cellular.json", None),
    # fluidigm: a CELLULAR decoder carries the multiplexing-classifier
    # flag (reference transcode.cpp:1087-1123 election by explicit flag)
    ("example/CBJLFACXX", "CBJLFACXX_l01_column.json", 3),
]


@pytest.mark.parametrize("rel,name,cardinality", VIGNETTES)
def test_vignette_end_to_end(reference_root, tmp_path, rel, name, cardinality):
    directory = os.path.join(reference_root, rel)
    compiled_probe = compile_config(directory, name, [])
    segments = compiled_probe["input segment cardinality"]
    if cardinality is not None:
        assert segments == cardinality

    paths = [str(tmp_path / f"s{s}.fastq") for s in range(segments)]
    synthesize(compiled_probe, paths, 800, seed=13)

    outputs = {}
    for fidelity in ("strict", "hybrid"):
        out = tmp_path / f"{name}.{fidelity}.sam"
        args = [
            "--config", name, "--precision", "15",
            "--fidelity", fidelity,
            "--output", str(out),
            "--report", str(tmp_path / f"{fidelity}.json"),
        ]
        for url in paths:
            args += ["-i", url]
        result = run_mux(directory, args)
        assert result.returncode == 0, (name, fidelity, result.stderr[-3000:])
        outputs[fidelity] = out

    assert decisions(outputs["strict"]) == decisions(outputs["hybrid"]), name

    report = json.loads((tmp_path / "strict.json").read_text())
    # pick the first decoder that actually classifies (the compiler
    # synthesizes a passthrough sample when none is configured)
    node = report.get("sample")
    if not (isinstance(node, dict) and node.get("classified")):
        node = report["cellular"]
    if isinstance(node, list):
        node = node[0]
    # synthetic reads come from the panel: the vast majority must classify
    assert node["classified count"] > 0.8 * node["count"], (name, node["count"])


def test_splitseq_prior_estimation_pass(reference_root, tmp_path):
    """SPLiT-seq + the two-pass prior workflow: estimation run emits
    adjusted priors that the second pass consumes."""
    directory = os.path.join(reference_root, "example/splitseq_vignette")
    name = "splitseq_l01_cellular.json"
    compiled_probe = compile_config(directory, name, [])
    segments = compiled_probe["input segment cardinality"]
    paths = [str(tmp_path / f"s{s}.fastq") for s in range(segments)]
    synthesize(compiled_probe, paths, 600, seed=29)

    adjusted_path = tmp_path / "adjusted.json"
    args = [
        "--config", name, "--precision", "15",
        "--output", "/dev/null",
        "--report", "/dev/null",
        "--prior", str(adjusted_path),
    ]
    for url in paths:
        args += ["-i", url]
    result = run_mux(directory, args)
    assert result.returncode == 0, result.stderr[-3000:]
    adjusted = json.loads(adjusted_path.read_text())
    cellular = adjusted["cellular"]
    if isinstance(cellular, dict):
        cellular = [cellular]
    assert any("noise" in decoder for decoder in cellular)

    # second pass with the adjusted configuration
    second = run_mux(
        str(tmp_path),
        [
            "--config", str(adjusted_path), "--precision", "15",
            "--base-input", str(tmp_path),
            "--output", "/dev/null", "--report", "/dev/stderr",
        ],
    )
    assert second.returncode == 0, second.stderr[-3000:]


def test_a5kvk_interleaved_cram_input(reference_root, tmp_path):
    """The A5KVK example (reference example/A5KVK/A5KVK.json): ONE CRAM
    listed four times as input — a 4-segment FI/TC-interleaved container
    feeding all four segment slots — with dual 7nt PAMLD barcodes.
    Synthesize the CRAM from the config's own codec and demux through
    the real CLI."""
    from pheniqs_tpu.io.cram import CramWriter
    from pheniqs_tpu.io.sam import AuxTags
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    config = json.load(
        open(os.path.join(reference_root, "example/A5KVK/A5KVK.json"))
    )
    config.pop("base input url")
    config["report url"] = "/dev/stderr"
    config["output"] = ["/dev/null"]
    words = [v["barcode"] for v in config["sample"]["codec"].values()]
    rng = np.random.default_rng(2)
    path = tmp_path / "A5KVK.cram"
    with open(path, "wb") as stream:
        writer = CramWriter(stream, "@HD\tVN:1.6\n", level=5)
        for i in range(200):
            barcode = words[rng.integers(len(words))]
            for s in range(4):
                if s == 1:
                    seq = barcode[0]
                elif s == 2:
                    seq = barcode[1]
                else:
                    seq = "".join(
                        "ACGT"[b] for b in rng.integers(4, size=40)
                    )
                tags = AuxTags()
                tags.FI = s + 1
                tags.TC = 4
                code = ASCII_TO_BAM[
                    np.frombuffer(seq.encode(), dtype=np.uint8)
                ]
                qual = rng.integers(25, 40, size=len(seq)).astype(np.uint8)
                writer.write_record(
                    f"r{i}", 0x4, code, qual, len(seq), tags
                )
        writer.close()
    config["input"] = [str(path)] * 4
    cfg = tmp_path / "job.json"
    cfg.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(cfg), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stderr)
    assert report["incoming"]["count"] == 200
    assert report["sample"]["classified fraction"] > 0.98
