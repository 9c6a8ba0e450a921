"""End-to-end workflow coverage: gzip ingest, --sense-input, the
in-process --prior two-pass flow, and report-driven prior parity."""

import json
import pytest
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_gzip_ingest_counts(reference_root, bdggg, tmp_path):
    """The .gz fixtures hold 2500 reads (10x the plain files); a demux run
    over them must count all of them."""
    config = {
        "import": [os.path.join(bdggg, "BDGGG_annotated.json")],
        "base input url": os.path.join(reference_root, "test/BDGGG"),
        "input": [
            "BDGGG_s01.fastq.gz",
            "BDGGG_s02.fastq.gz",
            "BDGGG_s03.fastq.gz",
        ],
        "output": ["/dev/null"],
        "report url": "/dev/stderr",
    }
    path = tmp_path / "gz_job.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stderr)
    assert report["incoming"]["count"] == 2500
    assert report["sample"]["count"] + 0 > 0


def test_sense_input_resolution(reference_root, tmp_path):
    """--sense-input over one interleaved FASTQ: three consecutive records
    share a read id, so the sensed resolution must be 3."""
    source = os.path.join(reference_root, "test/BDGGG")
    feeds = [open(os.path.join(source, f"BDGGG_s0{i}.fastq")) for i in (1, 2, 3)]
    interleaved = tmp_path / "interleaved.fastq"
    with open(interleaved, "w") as out:
        while True:
            records = []
            for feed in feeds:
                lines = [feed.readline() for _ in range(4)]
                if not lines[0]:
                    records = None
                    break
                records.append("".join(lines))
            if records is None:
                break
            out.write("".join(records))
    for feed in feeds:
        feed.close()

    config = {
        "input": [str(interleaved)],
        "output": ["/dev/null"],
        "report url": "/dev/stderr",
        "template": {"transform": {"token": ["0::", "2::"]}},
    }
    path = tmp_path / "sense_job.json"
    path.write_text(json.dumps(config))
    compiled = run_mux(
        str(tmp_path),
        ["--config", str(path), "--sense-input", "--compile", "--precision", "15"],
    )
    assert compiled.returncode == 0, compiled.stderr[-2000:]
    document = json.loads(compiled.stdout)
    assert document["input segment cardinality"] == 3
    assert document["feed"]["input feed"][0]["resolution"] == 3

    result = run_mux(
        str(tmp_path), ["--config", str(path), "--sense-input", "--precision", "15"]
    )
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stderr)
    assert report["incoming"]["count"] == 250


def test_in_process_prior_adjustment(reference_root, tmp_path):
    """`--prior adjusted.json` after a live run must write a config whose
    noise and concentrations equal the report's estimates (reference
    transcode.cpp:1884-1941)."""
    adjusted_path = tmp_path / "adjusted.json"
    result = run_mux(
        reference_root,
        [
            "--config", "test/BDGGG/BDGGG_annotated.json",
            "--precision", "15",
            "--output", "/dev/null",
            "--prior", str(adjusted_path),
        ],
    )
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stderr)
    adjusted = json.loads(adjusted_path.read_text())

    assert adjusted["sample"]["noise"] == report["sample"]["estimated noise"]
    estimated_by_barcode = {
        "".join(entry["barcode"]): entry.get("estimated concentration")
        for entry in report["sample"]["classified"]
    }
    for barcode in adjusted["sample"]["codec"].values():
        key = "".join(barcode["barcode"])
        expected = estimated_by_barcode.get(key)
        if expected is not None:
            assert barcode["concentration"] == expected


def test_parallel_engine_byte_identical(reference_root):
    """--threads 4 routes through the multiprocess engine; the BDGGG SAM
    stream must stay byte-identical (ordered batch writes) and the report
    counts must match the serial run."""
    serial = run_mux(
        reference_root,
        ["--config", "test/BDGGG/BDGGG_annotated.json", "--precision", "15"],
    )
    parallel = run_mux(
        reference_root,
        [
            "--config", "test/BDGGG/BDGGG_annotated.json", "--precision", "15",
            "--threads", "4", "--decoding-threads", "4",
        ],
    )
    assert parallel.returncode == 0, parallel.stderr[-2000:]
    strip = lambda text: "\n".join(
        line for line in text.split("\n") if not line.startswith("@PG")
    )
    assert strip(parallel.stdout) == strip(serial.stdout)
    serial_report = json.loads(serial.stderr)
    parallel_report = json.loads(parallel.stderr)
    for key in ("count", "pf count", "classified count"):
        assert serial_report["sample"][key] == parallel_report["sample"][key]


def test_sense_input_hts(reference_root, tmp_path):
    """--sense-input over a paired interleaved BAM feed: cardinality comes
    from the paired flag (reference hts total_segments sensing)."""
    bam = tmp_path / "sense.bam"
    result = run_mux(
        reference_root,
        [
            "--config", "test/BDGGG/BDGGG_annotated.json",
            "--precision", "15", "--output", str(bam),
        ],
    )
    assert result.returncode == 0, result.stderr[-2000:]

    config = {
        "input": [str(bam)],
        "output": ["/dev/null"],
        "report url": "/dev/stderr",
        "template": {"transform": {"token": ["0::", "1::"]}},
    }
    path = tmp_path / "sense_bam.json"
    path.write_text(json.dumps(config))
    compiled = run_mux(
        str(tmp_path),
        ["--config", str(path), "--sense-input", "--compile", "--precision", "15"],
    )
    assert compiled.returncode == 0, compiled.stderr[-2000:]
    document = json.loads(compiled.stdout)
    assert document["input segment cardinality"] == 2
    assert document["feed"]["input feed"][0]["resolution"] == 2

    executed = run_mux(
        str(tmp_path), ["--config", str(path), "--sense-input", "--precision", "15"]
    )
    assert executed.returncode == 0, executed.stderr[-2000:]
    report = json.loads(executed.stderr)
    assert report["incoming"]["count"] == 248


def test_host_shard_slicing(reference_root, tmp_path):
    """PHENIQS_SHARD=k:2 splits batches across two runs whose report counts
    sum to the full run (the multi-host ingest plan)."""
    def run(shard=None, batch="100"):
        env_extra = {"PHENIQS_SHARD": shard} if shard else {}
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.update(env_extra)
        result = subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config", "test/BDGGG/BDGGG_annotated.json",
                "--precision", "15", "--output", "/dev/null",
                "--batch-size", batch,
            ],
            cwd=reference_root, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert result.returncode == 0, result.stderr[-2000:]
        return json.loads(result.stderr)

    full = run()
    part0 = run("0:2")
    part1 = run("1:2")
    assert (
        part0["incoming"]["count"] + part1["incoming"]["count"]
        == full["incoming"]["count"]
    )
    assert (
        part0["sample"]["classified count"] + part1["sample"]["classified count"]
        == full["sample"]["classified count"]
    )


def test_empty_input(tmp_path):
    """Zero-read feeds produce an empty (header-only) stream and a report
    without incoming counts."""
    empty = tmp_path / "empty.fastq"
    empty.write_text("")
    config = {
        "input": [str(empty)],
        "output": [str(tmp_path / "out.sam")],
        "template": {"transform": {"token": ["0::"]}},
    }
    path = tmp_path / "empty.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-2000:]
    lines = (tmp_path / "out.sam").read_text().split("\n")
    assert all(not l or l.startswith("@") for l in lines)


def test_single_read(tmp_path):
    single = tmp_path / "one.fastq"
    single.write_text("@only 1:N:0:\nACGTACGT\n+\nIIIIIIII\n")
    config = {
        "input": [str(single)],
        "output": [str(tmp_path / "out.sam")],
        "report url": "/dev/stderr",
        "template": {"transform": {"token": ["0::"]}},
    }
    path = tmp_path / "one.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path), "--precision", "15"])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stderr)
    assert report["incoming"]["count"] == 1
    body = [
        l for l in (tmp_path / "out.sam").read_text().split("\n")
        if l and not l.startswith("@")
    ]
    assert len(body) == 1 and body[0].startswith("only\t")


def test_leading_segment_qcfail(reference_root, tmp_path):
    """--leading selects which segment's filter flag fails the read."""
    r1 = tmp_path / "r1.fastq"
    r2 = tmp_path / "r2.fastq"
    # read a: segment 0 passes, segment 1 fails; read b: inverse
    r1.write_text("@a 1:N:0:\nACGT\n+\nIIII\n@b 1:Y:0:\nACGT\n+\nIIII\n")
    r2.write_text("@a 2:Y:0:\nTGCA\n+\nIIII\n@b 2:N:0:\nTGCA\n+\nIIII\n")
    config = {
        "input": [str(r1), str(r2)],
        "output": [str(tmp_path / "out.sam")],
        "template": {"transform": {"token": ["0::", "1::"]}},
    }
    path = tmp_path / "lead.json"
    path.write_text(json.dumps(config))

    def fails(extra):
        result = run_mux(
            str(tmp_path), ["--config", str(path), "--precision", "15", *extra]
        )
        assert result.returncode == 0, result.stderr[-2000:]
        out = {}
        for line in (tmp_path / "out.sam").read_text().split("\n"):
            if line and not line.startswith("@"):
                fields = line.split("\t")
                out[fields[0]] = bool(int(fields[1]) & 0x200)
        return out

    default = fails([])
    assert default == {"a": False, "b": True}  # leader = segment 0
    swapped = fails(["--leading", "1"])
    assert swapped == {"a": True, "b": False}  # leader = segment 1


def test_partial_merge_matches_single_run(bdggg, tmp_path):
    """PHENIQS_SHARD partial workflow: H shard runs dump raw statistic sums
    (PHENIQS_PARTIAL), and tools.merge recombines them into the single-run
    report — integer statistics exactly, float sums to reassociation ulp.
    Quality-control channel histograms merge too."""
    config = {
        "import": [os.path.join(bdggg, "BDGGG_annotated.json")],
        "base input url": bdggg,
        "enable quality control": True,
        "output": ["/dev/null"],
        "report url": "/dev/stderr",
    }
    path = tmp_path / "job.json"
    path.write_text(json.dumps(config))
    args = ["--config", str(path), "--precision", "15", "--batch-size", "64"]

    single = run_mux(str(tmp_path), args)
    assert single.returncode == 0, single.stderr[-2000:]
    expected = json.loads(single.stderr)

    hosts = 3
    partials = []
    for k in range(hosts):
        partial = tmp_path / f"partial_{k}.json"
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["PHENIQS_SHARD"] = f"{k}:{hosts}"
        env["PHENIQS_PARTIAL"] = str(partial)
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux", *args,
             "--report", "/dev/null"],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert result.returncode == 0, (k, result.stderr[-2000:])
        partials.append(str(partial))

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    merge = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.tools.merge",
         "--config", str(path), *partials],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert merge.returncode == 0, merge.stderr[-2000:]
    merged = json.loads(merge.stdout)

    def compare(a, b, where=""):
        assert type(a) is type(b), (where, a, b)
        if isinstance(a, dict):
            assert set(a) == set(b), (where, set(a) ^ set(b))
            for key in a:
                compare(a[key], b[key], f"{where}/{key}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{where}[{i}]")
        elif isinstance(a, float):
            assert a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (
                where, a, b,
            )
        else:
            assert a == b, (where, a, b)

    compare(merged, expected)
    assert "multiplex" in merged  # quality-control channels survived the merge


def test_partial_merge_rejects_mismatched_config(bdggg, tmp_path):
    """A partial from a different decoder layout must be refused (exit 3)."""
    bogus = tmp_path / "bogus.json"
    bogus.write_text(json.dumps({"pheniqs partial": 1, "decoders": []}))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.tools.merge",
         "--config", os.path.join(bdggg, "BDGGG_annotated.json"), str(bogus)],
        cwd=bdggg, env=env, capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 3, (result.returncode, result.stderr[-500:])


def test_observability_envs(bdggg, tmp_path):
    """PHENIQS_TRACE=1 prints a phase summary, PHENIQS_PREFETCH=1 overlaps
    ingest, PHENIQS_PROFILE writes a jax.profiler trace dir — all without
    changing the output."""
    baseline = None
    for extra_env in (
        {},
        {"PHENIQS_TRACE": "1", "PHENIQS_PREFETCH": "1"},
        {"PHENIQS_PROFILE": str(tmp_path / "trace")},
    ):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.update(extra_env)
        fidelity = "fast" if "PHENIQS_PROFILE" in extra_env else "strict"
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", os.path.join(bdggg, "BDGGG_annotated.json"),
             "--base-input", bdggg, "--precision", "15",
             "--fidelity", fidelity, "--report", "/dev/null"],
            cwd=bdggg, env=env, capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, (extra_env, result.stderr[-2000:])
        decisions = [
            [
                f for f in line.split("\t")
                if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")
            ]
            for line in result.stdout.splitlines()
            if line and not line.startswith("@")
        ]
        if baseline is None:
            baseline = decisions
        else:
            assert decisions == baseline, extra_env
        if "PHENIQS_TRACE" in extra_env:
            assert "reads/s" in result.stderr or "trace" in result.stderr.lower(), (
                result.stderr[-500:]
            )
    assert (tmp_path / "trace").exists()


def test_autonomous_threads_multibatch_identical(reference_root, tmp_path):
    """--threads with multiple batches per worker: the autonomous strict
    workers must produce byte-identical SAM to serial (decisions are f64
    and per-read; chunk resequencing restores global input order), and
    count-level report fields must match exactly."""
    import json as json_mod

    base = reference_root + "/test/BDGGG"
    # replicate BDGGG 40x -> 10k reads; batch size 512 -> ~20 batches
    for s in (1, 2, 3):
        data = open(f"{base}/BDGGG_s0{s}.fastq", "rb").read()
        with open(tmp_path / f"BDGGG_s0{s}.fastq", "wb") as out:
            for _ in range(40):
                out.write(data)

    outputs = {}
    reports = {}
    for threads in ("1", "3"):
        result = run_mux(
            reference_root,
            [
                "--config", f"{base}/BDGGG_annotated.json",
                "--base-input", str(tmp_path),
                "--precision", "15",
                "--threads", threads,
                "--batch-size", "512",
            ],
        )
        assert result.returncode == 0, result.stderr[-2000:]
        outputs[threads] = "\n".join(
            line for line in result.stdout.splitlines()
            if not line.startswith("@PG")
        )
        reports[threads] = json_mod.loads(result.stderr)
    assert outputs["1"] == outputs["3"]
    for key in ("count", "pf count", "classified count"):
        assert (
            reports["1"]["sample"][key] == reports["3"]["sample"][key]
        ), key


@pytest.mark.parametrize("transport", ["shm", "replay", "ship", "autonomous"])
def test_stream_transports_byte_identical(reference_root, tmp_path, transport):
    """Every worker transport (tmpfs shm default, replay, ship, strict
    autonomous) must produce byte-identical SAM to the serial engine."""
    base = reference_root + "/test/BDGGG"
    for s in (1, 2, 3):
        data = open(f"{base}/BDGGG_s0{s}.fastq", "rb").read()
        with open(tmp_path / f"BDGGG_s0{s}.fastq", "wb") as out:
            for _ in range(8):
                out.write(data)

    outputs = {}
    for label, extra_env in (("serial", {}),
                             (transport, {"PHENIQS_STREAM_TRANSPORT": transport})):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.update(extra_env)
        args = [
            "--config", f"{base}/BDGGG_annotated.json",
            "--base-input", str(tmp_path),
            "--precision", "15",
            "--batch-size", "512",
        ]
        args += ["--threads", "1"] if label == "serial" else ["--threads", "3"]
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux", *args],
            cwd=reference_root, env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert result.returncode == 0, (label, result.stderr[-2000:])
        outputs[label] = "\n".join(
            line for line in result.stdout.splitlines()
            if not line.startswith("@PG")
        )
    assert outputs["serial"] == outputs[transport], transport


def test_zero_copy_staging_byte_identical(reference_root, tmp_path):
    """Zero-copy parse-into-slot staging (the native parser writing batch
    matrices straight into the tmpfs worker slot, PHENIQS_ZERO_COPY_STAGE=1
    default) must be byte-identical to the stage-time memcpy path (=0)
    through the shm streamed engine."""
    base = reference_root + "/test/BDGGG"
    for s in (1, 2, 3):
        data = open(f"{base}/BDGGG_s0{s}.fastq", "rb").read()
        with open(tmp_path / f"BDGGG_s0{s}.fastq", "wb") as out:
            for _ in range(8):
                out.write(data)

    outputs = {}
    for flag in ("0", "1"):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["PHENIQS_STREAM_TRANSPORT"] = "shm"
        env["PHENIQS_ZERO_COPY_STAGE"] = flag
        env["PHENIQS_TRACE"] = "1"
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", f"{base}/BDGGG_annotated.json",
             "--base-input", str(tmp_path),
             "--precision", "15",
             "--batch-size", "512",
             "--threads", "3"],
            cwd=reference_root, env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert result.returncode == 0, (flag, result.stderr[-2000:])
        # not vacuous: the trace ledger must show the zero-copy arena
        # actually engaged (parse_slot_zc_n counts try_acquire successes)
        # with the flag on, and stay silent with it off
        if flag == "1":
            assert "parse_slot_zc_n=" in result.stderr, result.stderr[-2000:]
        else:
            assert "parse_slot_zc_n=" not in result.stderr
        outputs[flag] = "\n".join(
            line for line in result.stdout.splitlines()
            if not line.startswith("@PG")
        )
    assert outputs["0"] == outputs["1"]


def test_cpu_device_mode_warning(reference_root, tmp_path):
    """--fidelity hybrid/fast on a CPU-only backend warns loudly (the
    measured-slowest engine there); strict does
    not warn; PHENIQS_QUIET_CPU_DEVICE=1 silences."""
    base = reference_root + "/test/BDGGG"
    runs = (
        ("hybrid", {}, True),
        ("fast", {}, True),
        ("strict", {}, False),
        ("hybrid", {"PHENIQS_QUIET_CPU_DEVICE": "1"}, False),
    )
    for fidelity, extra, expect in runs:
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("PHENIQS_QUIET_CPU_DEVICE", None)
        env.update(extra)
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", f"{base}/BDGGG_annotated.json",
             "--fidelity", fidelity,
             "--threads", "1",
             "--output", "/dev/null", "--report", "/dev/null"],
            cwd=reference_root, env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert result.returncode == 0, (fidelity, result.stderr[-1500:])
        fired = "CPU-only backend is the slowest" in result.stderr
        assert fired == expect, (fidelity, extra, result.stderr[-500:])
