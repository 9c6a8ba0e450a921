"""HTS container formats: BGZF/BAM roundtrip, BAM output vs golden SAM,
BAM/SAM input, FASTQ output with reconstructed Illumina comment."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from pheniqs_tpu.io.hts import BamWriter, read_bam, read_sam
from pheniqs_tpu.io.sam import AuxTags
from pheniqs_tpu.iupac import ASCII_TO_BAM, BAM_TO_ASCII

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_mux(reference_root, config, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [
            sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
            "--config", config, "--precision", "15", *extra,
        ],
        cwd=reference_root,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_bam_roundtrip(tmp_path):
    path = tmp_path / "roundtrip.bam"
    stream = open(path, "wb")
    writer = BamWriter(stream, "@HD\tVN:1.0\n")
    tags = AuxTags()
    tags.RG = "group1"
    tags.BC = "ACGT"
    tags.XB = 0.25
    code = ASCII_TO_BAM[np.frombuffer(b"ACGTN", dtype=np.uint8)]
    quality = np.array([30, 31, 32, 33, 2], dtype=np.uint8)
    writer.write_record("read1", 77, code, quality, 5, tags)
    writer.write_record("read2", 141, code[:4], quality[:4], 4, AuxTags())
    writer.close()
    stream.close()

    records = list(read_bam(str(path)))
    assert len(records) == 2
    assert records[0].name == b"read1"
    assert records[0].flag == 77
    assert BAM_TO_ASCII[records[0].code].tobytes() == b"ACGTN"
    np.testing.assert_array_equal(records[0].quality, quality)
    assert records[0].aux["RG"] == "group1"
    assert records[0].aux["BC"] == "ACGT"
    assert abs(records[0].aux["XB"] - 0.25) < 1e-7
    assert records[1].name == b"read2"
    assert len(records[1].code) == 4


@pytest.fixture(scope="module")
def bam_output(reference_root, tmp_path_factory):
    path = tmp_path_factory.mktemp("bam") / "bdggg.bam"
    result = run_mux(
        reference_root,
        "test/BDGGG/BDGGG_annotated.json",
        extra=("--output", str(path)),
    )
    assert result.returncode == 0, result.stderr[-2000:]
    return str(path)


def test_bam_output_matches_golden_sam(reference_root, bam_output):
    golden = [
        line.split("\t")
        for line in open(
            os.path.join(reference_root, "test/BDGGG/valid/annotated.out")
        )
        if not line.startswith("@")
    ]
    records = list(read_bam(bam_output))
    assert len(records) == len(golden)
    for fields, record in zip(golden, records):
        assert fields[0] == record.name.decode()
        assert int(fields[1]) == record.flag
        assert fields[9] == BAM_TO_ASCII[record.code].tobytes().decode()
        assert fields[10] == (record.quality + 33).tobytes().decode()
        for field in fields[11:]:
            tag, kind, value = field.strip().split(":", 2)
            got = record.aux[tag]
            if kind == "f":
                assert abs(float(value) - got) <= 1e-6 * max(1.0, abs(float(value)))
            elif kind == "i":
                assert int(value) == got
            else:
                assert value == str(got)


def test_bam_input_passthrough_roundtrip(bam_output, tmp_path):
    config = tmp_path / "roundtrip.json"
    out = tmp_path / "roundtrip.sam"
    config.write_text(
        "{\n"
        f'    "input": ["{bam_output}", "{bam_output}"],\n'
        f'    "output": ["{out}"],\n'
        '    "template": { "transform": { "token": ["0::", "1::"] } }\n'
        "}\n"
    )
    result = run_mux(str(tmp_path), str(config))
    assert result.returncode == 0, result.stderr[-2000:]
    records = list(read_bam(bam_output))
    lines = [
        line.split("\t")
        for line in open(out)
        if not line.startswith("@")
    ]
    assert len(lines) == len(records)
    for fields, record in zip(lines, records):
        assert fields[0] == record.name.decode()
        assert fields[9] == BAM_TO_ASCII[record.code].tobytes().decode()


def test_sam_reader(reference_root):
    path = os.path.join(reference_root, "test/BDGGG/valid/annotated.out")
    records = list(read_sam(path))
    assert len(records) == 496
    assert records[0].aux["RG"].startswith("BDGGG")
    assert records[0].total_segments == 2  # paired flag


def test_fastq_output_comment(reference_root, tmp_path):
    path = tmp_path / "out.fastq.gz"
    result = run_mux(
        reference_root,
        "test/BDGGG/BDGGG_annotated.json",
        extra=("--output", str(path)),
    )
    assert result.returncode == 0, result.stderr[-2000:]
    lines = gzip.open(path, "rt").read().rstrip("\n").split("\n")
    assert len(lines) % 4 == 0
    header = lines[0]
    name, comment = header[1:].split(" ")
    segment, fail, control, barcode = comment.split(":")
    assert segment == "1" and fail in "YN" and control == "0"
    assert set(barcode) <= set("ACGTN=")
    assert set(lines[1]) <= set("ACGTN=")


def test_reg2bin_matches_spec():
    """SAM spec section 5.3 interval bins (hand-computed vectors)."""
    from pheniqs_tpu.io.hts import reg2bin

    assert reg2bin(0, 1) == 4681
    assert reg2bin(0, 1 << 14) == 4681
    assert reg2bin((1 << 14) - 1, (1 << 14) + 1) == 585
    assert reg2bin(1 << 26, (1 << 26) + 100) == 4681 + (1 << 12)
    assert reg2bin(0, 1 << 28) == 0
    assert reg2bin(9999, 10000 + 36) == 4681  # a 36bp read at pos 9999


def test_mapped_bam_record_bin_field(tmp_path):
    """write_hts_record must store reg2bin(pos, end) for mapped records
    (validators and region indexes check it), UNMAPPED_BIN otherwise
    (regression: round-3 review)."""
    import gzip
    import struct

    import numpy as np

    from pheniqs_tpu.io.hts import BamWriter, HtsRecord, reg2bin

    header = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n"
    code = np.array([1, 2, 4, 8] * 9, dtype=np.uint8)
    qual = np.full(36, 30, dtype=np.uint8)
    mapped = HtsRecord(
        b"m0", 0, code, qual, {}, ref_id=0, pos=9999, mapq=37,
        cigar=[("S", 4), ("M", 20), ("D", 5), ("M", 12)],
    )
    unmapped = HtsRecord(b"u0", 0x4, code, qual, {})
    path = tmp_path / "bins.bam"
    with open(path, "wb") as stream:
        writer = BamWriter(stream, header, references=[("chr1", 100000)])
        writer.write_hts_record(mapped)
        writer.write_hts_record(unmapped)
        writer.close()

    raw = gzip.decompress(path.read_bytes())
    assert raw[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", raw, 4)
    offset = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, offset)
    offset += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, offset)
        offset += 4 + l_name + 4
    bins = []
    for _ in range(2):
        (block_size,) = struct.unpack_from("<i", raw, offset)
        (bin_mq_nl,) = struct.unpack_from("<I", raw, offset + 4 + 8)
        bins.append(bin_mq_nl >> 16)
        offset += 4 + block_size
    # reference span: 20 M + 5 D + 12 M = 37 bases from pos 9999
    assert bins[0] == reg2bin(9999, 9999 + 37)
    assert bins[1] == 4680


def test_columnar_bam_output_byte_identical_to_per_record(
    reference_root, tmp_path, monkeypatch
):
    """The native columnar BAM render (bam_format_full through
    _route_and_write_columns) must produce byte-for-byte the per-record
    AuxTags fallback's output on the BDGGG demux."""
    import gzip
    import subprocess
    import sys

    out = tmp_path / "out.bam"

    def run(env_extra):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.update(env_extra)
        subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config",
                os.path.join(reference_root, "test/BDGGG/BDGGG_annotated.json"),
                "--precision", "15", "--threads", "1",
                "--output", str(out),
                "--report", str(tmp_path / "report.json"),
            ],
            cwd=str(reference_root),
            check=True,
            capture_output=True,
            env=env,
        )
        return gzip.decompress(out.read_bytes())

    columnar = run({})
    fallback = run({"PHENIQS_BAM_COLUMNS": "0"})
    assert columnar == fallback
    assert len(columnar) > 100000


def test_streamed_compressed_outputs_parse_and_match_serial(
    reference_root, tmp_path
):
    """--threads N with --output x.bam / x.sam.gz must produce readable
    files whose records equal the serial run's (regression: the parent's
    BGZF-buffered header used to flush AFTER the worker chunks, and the
    URL model silently dropped .sam.gz compression entirely)."""
    import gzip
    import subprocess
    import sys

    def run(threads, out):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config",
                os.path.join(reference_root, "test/BDGGG/BDGGG_annotated.json"),
                "--precision", "15", "--threads", str(threads),
                "--output", str(out), "--report", "/dev/null",
            ],
            cwd=str(reference_root), check=True, capture_output=True, env=env,
        )

    for suffix, parse in (
        (
            "bam",
            lambda p: [
                (r.name, r.flag, r.code.tobytes(), sorted(r.aux.items()))
                for r in read_bam(str(p))
            ],
        ),
        (
            "sam.gz",
            lambda p: [
                line
                for line in gzip.decompress(p.read_bytes())
                .decode()
                .splitlines()
                if not line.startswith("@")
            ],
        ),
    ):
        serial = tmp_path / f"serial.{suffix}"
        streamed = tmp_path / f"streamed.{suffix}"
        run(1, serial)
        run(4, streamed)
        records = parse(streamed)
        assert records == parse(serial)
        assert len(records) > 400
    # the gzip file must lead with the compressed header block
    raw = (tmp_path / "streamed.sam.gz").read_bytes()
    assert raw[:2] == b"\x1f\x8b"
    first = gzip.decompress(raw).decode().splitlines()[0]
    assert first.startswith("@HD")
