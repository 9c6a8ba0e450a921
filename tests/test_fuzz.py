"""Robustness fuzzing: malformed FASTQ never crashes the native parser
(typed errors only), and randomized multi-decoder instruments agree
between the strict and fast engines."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from struct import error as struct_error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "ACGT"


def test_native_parser_garbage(tmp_path):
    from pheniqs_tpu import native
    from pheniqs_tpu.errors import SequenceError

    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(0)
    for trial in range(25):
        blob = bytes(rng.integers(0, 256, size=rng.integers(0, 400), dtype=np.uint8))
        path = tmp_path / f"garbage{trial}.fastq"
        path.write_bytes(blob)
        reader = native.NativeFastqReader(str(path))
        try:
            while reader.read_batch(64) is not None:
                pass
        except SequenceError:
            pass  # typed failure is the contract
        finally:
            reader.close()


def test_truncated_fastq_typed_error(tmp_path):
    from pheniqs_tpu import native
    from pheniqs_tpu.errors import SequenceError

    if not native.available():
        pytest.skip("native unavailable")
    path = tmp_path / "trunc.fastq"
    path.write_text("@read1\nACGT\n+\n")  # missing quality line
    reader = native.NativeFastqReader(str(path))
    with pytest.raises(SequenceError):
        reader.read_batch(4)


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_random_instrument_strict_vs_fast(tmp_path, seed):
    """Random multi-decoder instruments (pamld sample + mdd cellular +
    naive molecular over random token layouts): fast decisions equal
    strict."""
    rng = np.random.default_rng(seed)

    def panel(count, width):
        out = set()
        while len(out) < count:
            out.add("".join(rng.choice(list(BASES), size=width)))
        return sorted(out)

    sample_width = int(rng.integers(6, 12))
    cell_width = int(rng.integers(6, 12))
    umi_width = int(rng.integers(4, 10))
    read_length = sample_width + cell_width + umi_width + int(rng.integers(5, 20))
    sample_panel = panel(int(rng.integers(4, 12)), sample_width)
    cell_panel = panel(int(rng.integers(4, 12)), cell_width)

    reads = tmp_path / f"reads{seed}.fastq"
    n = 1500
    with open(reads, "w") as stream:
        for i in range(n):
            sequence = [BASES[b] for b in rng.integers(4, size=read_length)]
            sample_word = sample_panel[rng.integers(len(sample_panel))]
            cell_word = cell_panel[rng.integers(len(cell_panel))]
            sequence[0:sample_width] = list(sample_word)
            sequence[sample_width : sample_width + cell_width] = list(cell_word)
            quality = rng.integers(2, 41, size=read_length)
            for position in range(read_length):
                if rng.random() < 0.06:
                    sequence[position] = BASES[rng.integers(4)]
            qual = "".join(chr(q + 33) for q in quality)
            stream.write(f"@f{i}\n{''.join(sequence)}\n+\n{qual}\n")

    config = {
        "input": [str(reads)],
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "algorithm": "pamld",
            "confidence threshold": float(rng.choice([0.8, 0.95, 0.99])),
            "noise": float(rng.choice([0.01, 0.05, 0.2])),
            "transform": {"token": [f"0::{sample_width}"]},
            "codec": {f"@{w}": {"barcode": [w]} for w in sample_panel},
        },
        "cellular": [
            {
                "algorithm": "mdd",
                "distance tolerance": [int(rng.integers(0, 3))],
                "transform": {
                    "token": [f"0:{sample_width}:{sample_width + cell_width}"]
                },
                "codec": {f"@{w}": {"barcode": [w]} for w in cell_panel},
            }
        ],
        "molecular": [
            {
                "algorithm": "naive",
                "transform": {
                    "token": [
                        f"0:{sample_width + cell_width}:"
                        f"{sample_width + cell_width + umi_width}"
                    ]
                },
            }
        ],
    }

    def run(fidelity):
        job = dict(config)
        out = tmp_path / f"{fidelity}{seed}.sam"
        job["output"] = [str(out)]
        path = tmp_path / f"job_{fidelity}{seed}.json"
        path.write_text(json.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        result = subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config", str(path), "--precision", "15",
                "--fidelity", fidelity,
            ],
            cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, result.stderr[-3000:]
        return [
            [f for f in line.split("\t") if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")]
            for line in out.read_text().split("\n")
            if line and not line.startswith("@")
        ]

    assert run("strict") == run("hybrid")


def test_cram_reader_garbage(tmp_path):
    """Corrupt or random CRAM bytes must fail with typed errors (IOError_),
    never crash or hang."""
    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu.io.cram import read_cram

    rng = np.random.default_rng(41)
    for trial in range(25):
        blob = b"CRAM\x03\x00" + bytes(
            rng.integers(0, 256, size=int(rng.integers(0, 300)), dtype=np.uint8)
        )
        path = tmp_path / f"garbage{trial}.cram"
        path.write_bytes(blob)
        try:
            list(read_cram(str(path)))
        except (IOError_, IndexError, ValueError, EOFError, struct_error):
            pass


def test_cram_bitflip_detected(tmp_path):
    """A single corrupted byte inside a container is caught by the CRC or
    surfaces as a typed error — silent corruption is not acceptable."""
    from pheniqs_tpu.errors import PheniqsError
    from pheniqs_tpu.io.cram import CramWriter, read_cram
    from pheniqs_tpu.io.sam import AuxTags

    path = tmp_path / "x.cram"
    with open(path, "wb") as stream:
        writer = CramWriter(stream, "@HD\tVN:1.0\n", level=5)
        rng = np.random.default_rng(5)
        for i in range(200):
            code = np.array([1, 2, 4, 8] * 10, dtype=np.uint8)
            qual = rng.integers(2, 40, size=40).astype(np.uint8)
            writer.write_record(f"r{i}", 0x4, code, qual, 40, AuxTags())
        writer.close()
    blob = bytearray(path.read_bytes())
    baseline = [r.name for r in read_cram(str(path))]
    assert len(baseline) == 200

    rng = np.random.default_rng(77)
    detected = 0
    for trial in range(20):
        corrupted = bytearray(blob)
        position = int(rng.integers(30, len(blob) - 40))
        corrupted[position] ^= 0xFF
        bad = tmp_path / f"bad{trial}.cram"
        bad.write_bytes(bytes(corrupted))
        try:
            records = list(read_cram(str(bad)))
            if [r.name for r in records] != baseline:
                detected += 1  # wrong content surfaced as a difference
        except (PheniqsError, IndexError, ValueError, EOFError, struct_error):
            detected += 1
    assert detected >= 18  # CRCs catch essentially every flip


def test_bam_truncated_mid_record_fails_typed(tmp_path):
    """A BAM whose last record body is cut short must raise a typed
    IOError through the buffered per-record reader (a trailing partial
    length word alone is EOF, matching htslib's tolerance)."""
    import struct

    import numpy as np

    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu.io.hts import BamWriter, read_bam

    path = tmp_path / "whole.bam"
    with open(path, "wb") as stream:
        writer = BamWriter(stream, "@HD\tVN:1.0\n", 5)
        from pheniqs_tpu.io.sam import AuxTags

        for i in range(50):
            writer.write_record(
                f"r{i}", 0x4, np.full(30, 1, np.uint8),
                np.full(30, 30, np.uint8), 30, AuxTags(),
            )
        writer.close()
    import gzip as gzip_mod

    raw = gzip_mod.open(path, "rb").read()
    # cut inside the last record's body (past its length word)
    truncated = tmp_path / "cut.bam"
    with open(truncated, "wb") as out:
        from pheniqs_tpu.io.hts import BgzfWriter

        writer = BgzfWriter(out, 5)
        writer.write(raw[:-20])
        writer.close()
    with pytest.raises(IOError_):
        list(read_bam(str(truncated)))


def test_native_bam_garbage_fails_typed(tmp_path):
    """Crafted/corrupt BAM through the native batch reader must fail typed
    (negative l_seq, truncated bodies) — never read out of bounds."""
    import struct
    import numpy as np
    from pheniqs_tpu import native
    from pheniqs_tpu.errors import SequenceError
    from pheniqs_tpu.io.hts import BgzfWriter

    import pytest

    if not native.available():
        pytest.skip("native library unavailable")

    # valid BAM prologue, then a record with l_seq = -5
    body = bytearray(48)
    struct.pack_into("<i", body, 0, -1)        # refID
    struct.pack_into("<i", body, 4, -1)        # pos
    body[8] = 3                                # l_read_name
    struct.pack_into("<H", body, 12, 0)        # n_cigar
    struct.pack_into("<H", body, 14, 4)        # flag
    struct.pack_into("<i", body, 16, -5)       # l_seq NEGATIVE
    payload = (
        b"BAM\x01"
        + struct.pack("<i", 11) + b"@HD\tVN:1.0\n"
        + struct.pack("<i", 0)                 # n_ref
        + struct.pack("<i", len(body)) + bytes(body)
    )
    path = tmp_path / "crafted.bam"
    with open(path, "wb") as raw:
        writer = BgzfWriter(raw, 5)
        writer.write(payload)
        writer.close()

    reader = native.NativeBamReader(str(path))
    try:
        with pytest.raises(SequenceError):
            while reader.read_batch(64) is not None:
                pass
    finally:
        reader.close()


def test_native_cram_reader_bitflips_fail_typed(tmp_path):
    """Byte flips anywhere in a CRAM file must surface as typed errors
    through the native batch reader (CRC trailers catch block damage; the
    slice decoder and its Python fallback fail typed on the rest)."""
    import numpy as np
    import pytest

    from pheniqs_tpu import native
    from pheniqs_tpu.errors import PheniqsError
    from pheniqs_tpu.io.cram import CramWriter, NativeCramReader
    from pheniqs_tpu.io.sam import AuxTags
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    if not native.available():
        pytest.skip("native library unavailable")

    path = tmp_path / "flip.cram"
    with open(path, "wb") as stream:
        writer = CramWriter(stream, "@HD\tVN:1.0\n")
        code = ASCII_TO_BAM[np.frombuffer(b"ACGTACGTACGT", dtype=np.uint8)]
        qual = np.full(12, 30, np.uint8)
        for i in range(500):
            writer.write_record(f"r{i}", 77, code, qual, 12, AuxTags())
        writer.close()
    blob = bytearray(path.read_bytes())

    rng = np.random.default_rng(13)
    failures = 0
    for _ in range(12):
        flipped = bytearray(blob)
        index = int(rng.integers(30, len(flipped)))
        flipped[index] ^= 0xFF
        target = tmp_path / "flipped.cram"
        target.write_bytes(bytes(flipped))
        try:
            reader = NativeCramReader(str(target))
            while reader.read_batch(256) is not None:
                pass
        except PheniqsError:
            failures += 1
        except Exception as error:  # noqa: BLE001
            raise AssertionError(
                f"untyped {type(error).__name__} at flip {index}: {error}"
            )
    # most flips must be detected (a flip inside a name byte is legal)
    assert failures >= 6, failures


def test_fastq_garbage_quality_bytes_clamp_not_crash(tmp_path):
    """Binary garbage in a FASTQ quality line (bytes above '~' or below
    the phred offset) must clamp into the classification quality domain
    [0, 0x80) on BOTH parsers — the native reader and the Python
    fallback — never crash the oracle or index the substitution LUT out
    of bounds."""
    import numpy as np

    from pheniqs_tpu.io.fastq import read_fastq

    path = tmp_path / "garbage.fastq"
    quality_line = bytes([250, 33, 20, 126, 255, 70, 33, 33])
    path.write_bytes(
        b"@r1 1:N:0:\nACGTACGT\n+\n" + quality_line + b"\n"
        b"@r2 1:N:0:\nACGTACGT\n+\nIIIIIIII\n"
    )
    records = list(read_fastq(str(path)))
    assert len(records) == 2
    quality = np.frombuffer(records[0].quality, np.uint8)
    assert int(quality.max()) <= 0x7F
    assert quality[0] == 0x7F  # 250-33 clamps down
    assert quality[2] == 0     # 20 < offset clamps up

    from pheniqs_tpu import native

    if native.available():
        from pheniqs_tpu.io.ingest import native_read_batches

        batches = list(
            native_read_batches([str(path)], 33, 16)
        )
        (batch,) = batches
        segment = batch.segments[0]
        assert int(segment.quality.max()) <= 0x7F
        np.testing.assert_array_equal(
            segment.quality[0][: len(quality)], quality
        )
