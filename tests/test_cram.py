"""CRAM 3.0 codec: round-trip equivalence against the BAM codec, varint
edge cases, and the end-to-end demux --output x.cram path."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from pheniqs_tpu.io.cram import (
    CramWriter,
    itf8_get,
    itf8_put,
    ltf8_get,
    ltf8_put,
    read_cram,
)
from pheniqs_tpu.io.hts import BamWriter, read_bam
from pheniqs_tpu.io.sam import AuxTags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "value",
    [0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000, 0xFFFFFFF,
     0x10000000, 0x7FFFFFFF, -1, -2, -2147483648],
)
def test_itf8_round_trip(value):
    encoded = itf8_put(value)
    decoded, offset = itf8_get(encoded, 0)
    assert decoded == value
    assert offset == len(encoded)


@pytest.mark.parametrize(
    "value",
    [0, 1, 127, 128, 0x3FFF, 1 << 20, 1 << 34, 1 << 48, (1 << 55) - 1,
     1 << 55, (1 << 62)],
)
def test_ltf8_round_trip(value):
    encoded = ltf8_put(value)
    decoded, offset = ltf8_get(encoded, 0)
    assert decoded == value
    assert offset == len(encoded)


HEADER = (
    "@HD\tVN:1.0\tSO:unknown\tGO:query\n"
    "@RG\tID:BDGGG:1:AGGCATG\tPU:BDGGG:1:AGGCATG\tSM:one\n"
    "@RG\tID:undetermined\tPU:undetermined\n"
)


def synthetic_records(n, seed=7):
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    records = []
    for i in range(n):
        length = int(rng.integers(0, 40)) if i % 17 == 0 else int(
            rng.integers(20, 60)
        )
        code = codes[rng.integers(len(codes), size=length)]
        qual = rng.integers(2, 42, size=length).astype(np.uint8)
        tags = AuxTags()
        tags.RG = "BDGGG:1:AGGCATG" if i % 3 else "undetermined"
        tags.BC = "AGGCATG"
        tags.QT = "IIIIIII"
        if i % 3 == 0:
            tags.XB = 0.125 + i / 1000.0
        if i % 5 == 0:
            tags.RX = "ACGT"
            tags.QX = "IIII"
        if i % 7 == 0:
            tags.FI = (i % 3) + 1
            tags.TC = 3
        flag = 0x4D if i % 2 else 0x8E  # paired/first vs last/mate-unmapped
        flag |= 0x200 if i % 11 == 0 else 0
        records.append((f"read{i}", flag, code, qual, length, tags))
    return records


def test_cram_round_trip_matches_bam(tmp_path):
    """Writing the same records through the CRAM and BAM codecs and
    reading both back must produce identical HtsRecords."""
    records = synthetic_records(900)  # spans >1 slice (RECORDS_PER_SLICE//...)
    cram_path = tmp_path / "x.cram"
    bam_path = tmp_path / "x.bam"
    with open(cram_path, "wb") as stream:
        writer = CramWriter(stream, HEADER, level=5)
        writer.RECORDS_PER_SLICE = 256  # force multiple containers
        for record in records:
            writer.write_record(*record)
        writer.close()
    with open(bam_path, "wb") as stream:
        writer = BamWriter(stream, HEADER, 5)
        for record in records:
            writer.write_record(*record)
        writer.close()

    got = list(read_cram(str(cram_path)))
    want = list(read_bam(str(bam_path)))
    assert len(got) == len(want) == len(records)
    for mine, theirs in zip(got, want):
        assert mine.name == theirs.name
        assert mine.flag == (theirs.flag | 0x4)
        np.testing.assert_array_equal(mine.code, theirs.code)
        np.testing.assert_array_equal(mine.quality, theirs.quality)
        assert mine.aux == theirs.aux


def run_mux(cwd, args, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
    )


def test_demux_cram_output_and_input(reference_root, tmp_path):
    """--output x.cram carries the same records as --output x.bam, and the
    CRAM file feeds back in as interleaved input for a passthrough run."""
    out_cram = tmp_path / "out.cram"
    out_bam = tmp_path / "out.bam"
    for out in (out_cram, out_bam):
        result = run_mux(
            reference_root,
            ["--config", "test/BDGGG/BDGGG_annotated.json", "--precision", "15",
             "--output", str(out), "--report", "/dev/null"],
        )
        assert result.returncode == 0, result.stderr[-2000:]

    got = list(read_cram(str(out_cram)))
    want = list(read_bam(str(out_bam)))
    assert len(got) == len(want) > 0
    for mine, theirs in zip(got, want):
        assert mine.name == theirs.name
        assert mine.flag == theirs.flag  # demux output always sets 0x4
        np.testing.assert_array_equal(mine.code, theirs.code)
        np.testing.assert_array_equal(mine.quality, theirs.quality)
        assert mine.aux == theirs.aux

    # feed the CRAM back in: passthrough re-emission to SAM must carry
    # every record through the HTS input path
    config = {
        "input": [str(out_cram)],
        "template": {"transform": {"token": ["0::"]}},
        "output": [str(tmp_path / "echo.sam")],
        "report url": "/dev/null",
    }
    path = tmp_path / "echo.json"
    path.write_text(json.dumps(config))
    result = run_mux(str(tmp_path), ["--config", str(path)])
    assert result.returncode == 0, result.stderr[-2000:]
    lines = [
        line for line in open(tmp_path / "echo.sam")
        if line.strip() and not line.startswith("@")
    ]
    assert len(lines) == len(got)



def record_containers(path):
    """Bytes past a CRAM's header container (whose @PG CL line — or the
    absence of one — legitimately differs between command lines)."""
    from pheniqs_tpu.io.cram import _parse_container_header

    buf = path.read_bytes() if hasattr(path, "read_bytes") else open(path, "rb").read()
    _ref, _n, _blocks, length, offset = _parse_container_header(buf, 26)
    return buf[offset + length:]


def test_streamed_cram_output_byte_identical_to_serial(
    reference_root, tmp_path
):
    """`--output x.cram --threads 3` streams slice parts from render
    workers and must produce the SAME BYTES as the serial run: the
    columnar route slices per engine batch in both topologies and the
    parent stamps the sequential record counters in raw batch order
    (io/cram.py CramPartBuilder; the reference reaches the same effect
    through htslib's threaded codec pool, transcode.cpp:1599-1605)."""
    serial = tmp_path / "serial.cram"
    streamed = tmp_path / "streamed.cram"
    for out, threads in ((serial, "1"), (streamed, "3")):
        result = run_mux(
            reference_root,
            ["--config", "test/BDGGG/BDGGG_annotated.json",
             "--precision", "15", "--batch-size", "64",
             "--threads", threads,
             "--output", str(out), "--report", "/dev/null"],
        )
        assert result.returncode == 0, result.stderr[-2000:]

    tail = record_containers(serial)
    assert tail and tail == record_containers(streamed)


def test_streamed_cram_per_record_route_content_identical(
    reference_root, tmp_path
):
    """The per-record CRAM fallback (PHENIQS_BAM_COLUMNS=0) flushes its
    pending slice at every worker chunk, so container framing may differ
    from serial — the decoded records must not."""
    serial = tmp_path / "serial.cram"
    streamed = tmp_path / "streamed.cram"
    for out, threads in ((serial, "1"), (streamed, "3")):
        result = run_mux(
            reference_root,
            ["--config", "test/BDGGG/BDGGG_annotated.json",
             "--precision", "15", "--batch-size", "64",
             "--threads", threads,
             "--output", str(out), "--report", "/dev/null"],
            extra_env={"PHENIQS_BAM_COLUMNS": "0"},
        )
        assert result.returncode == 0, result.stderr[-2000:]
    got = list(read_cram(str(streamed)))
    want = list(read_cram(str(serial)))
    assert len(got) == len(want) > 0
    for mine, theirs in zip(got, want):
        assert mine.name == theirs.name
        assert mine.flag == theirs.flag
        np.testing.assert_array_equal(mine.code, theirs.code)
        np.testing.assert_array_equal(mine.quality, theirs.quality)
        assert mine.aux == theirs.aux


def test_fast_fidelity_streamed_cram_matches_serial(reference_root, tmp_path):
    """Device-mode render workers (fast fidelity) carry the CRAM part
    route too: `--fidelity fast --threads 3` output must match the
    fast serial run byte-for-byte past the header container."""
    serial = tmp_path / "serial.cram"
    streamed = tmp_path / "streamed.cram"
    for out, threads in ((serial, "1"), (streamed, "3")):
        result = run_mux(
            reference_root,
            ["--config", "test/BDGGG/BDGGG_annotated.json",
             "--precision", "15", "--batch-size", "64",
             "--threads", threads, "--fidelity", "fast",
             "--output", str(out), "--report", "/dev/null"],
        )
        assert result.returncode == 0, result.stderr[-2000:]

    tail = record_containers(serial)
    assert tail and tail == record_containers(streamed)


def test_streamed_mixed_cram_and_sam_outputs(reference_root, tmp_path):
    """One CRAM feed and one SAM feed on the same streamed run: mixed
    formats take the per-record route, whose worker chunks carry pickled
    slice parts for the CRAM feed and plain text for the SAM feed —
    both must match their serial-run content."""
    outs = {}
    for threads in ("1", "3"):
        cram = tmp_path / f"t{threads}.cram"
        sam = tmp_path / f"t{threads}.sam"
        config = {
            "input": [
                str(os.path.join(
                    reference_root, "test/BDGGG", f"BDGGG_s0{s}.fastq"
                ))
                for s in (1, 2, 3)
            ],
            "template": {"transform": {"token": ["0::", "2::"]}},
            "output": [str(cram), str(sam)],
            "report url": "/dev/null",
        }
        path = tmp_path / f"job{threads}.json"
        path.write_text(json.dumps(config))
        result = run_mux(
            str(tmp_path),
            ["--config", str(path), "--batch-size", "64",
             "--threads", threads],
        )
        assert result.returncode == 0, result.stderr[-2000:]
        sam_lines = [
            line for line in sam.read_text().splitlines()
            if not line.startswith("@")
        ]
        outs[threads] = (list(read_cram(str(cram))), sam_lines)

    serial_cram, serial_sam = outs["1"]
    streamed_cram, streamed_sam = outs["3"]
    assert serial_sam == streamed_sam and len(serial_sam) > 0
    assert len(serial_cram) == len(streamed_cram) > 0
    for mine, theirs in zip(streamed_cram, serial_cram):
        assert mine.name == theirs.name
        assert mine.flag == theirs.flag
        np.testing.assert_array_equal(mine.code, theirs.code)
        assert mine.aux == theirs.aux


def test_streamed_split_cram_outputs_match_serial(tmp_path):
    """Per-barcode split `.cram` outputs (one feed per channel) through
    the streamed engine: every file must be byte-identical to the serial
    run past its header container."""
    rng = np.random.default_rng(31)
    bases = "ACGT"
    panel = []
    while len(panel) < 4:
        word = "".join(rng.choice(list(bases), size=8))
        if word not in panel:
            panel.append(word)
    reads = tmp_path / "reads.fastq"
    with open(reads, "w") as stream:
        for i in range(3000):
            word = list(panel[rng.integers(len(panel))]) + list(
                rng.choice(list(bases), size=12)
            )
            for position in range(20):
                if rng.random() < 0.02:
                    word[position] = bases[rng.integers(4)]
            qual = "".join(chr(int(q) + 33) for q in rng.integers(20, 40, 20))
            stream.write(f"@r{i}\n{''.join(word)}\n+\n{qual}\n")

    def run(threads, tag):
        codec = {
            f"@{w}": {
                "barcode": [w],
                "output": [str(tmp_path / f"{tag}_{w}.cram")],
            }
            for w in panel
        }
        config = {
            "input": [str(reads)],
            "template": {"transform": {"token": ["0::"]}},
            "sample": {
                "algorithm": "pamld",
                "confidence threshold": 0.9,
                "transform": {"token": ["0::8"]},
                "codec": codec,
                "undetermined": {
                    "output": [str(tmp_path / f"{tag}_undet.cram")]
                },
            },
            "output": [str(tmp_path / f"{tag}_undet.cram")],
            "report url": "/dev/null",
        }
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps(config))
        result = run_mux(
            str(tmp_path),
            ["--config", str(path), "--batch-size", "512",
             "--threads", threads],
        )
        assert result.returncode == 0, result.stderr[-2000:]
        return [f"{tag}_{w}.cram" for w in panel] + [f"{tag}_undet.cram"]

    serial = run("1", "s")
    streamed = run("3", "t")

    total = 0
    for a, b in zip(serial, streamed):
        ta, tb = record_containers(tmp_path / a), record_containers(tmp_path / b)
        assert ta == tb, (a, b)
        total += len(ta)
    assert total > 0


def test_itf8_decode_vec_matches_scalar():
    """The pointer-jump vectorized ITF-8 decoder must agree with itf8_get
    across every length class, including negatives and 5-byte forms."""
    from pheniqs_tpu.io.cram import itf8_decode_vec

    rng = np.random.default_rng(17)
    values = np.concatenate([
        rng.integers(0, 0x80, 200),
        rng.integers(0x80, 0x4000, 200),
        rng.integers(0x4000, 0x200000, 200),
        rng.integers(0x200000, 0x10000000, 200),
        rng.integers(0x10000000, 0x7FFFFFFF, 200),
        np.array([-1, -2, 0, 1, 0x7FFFFFFF, -2147483648]),
    ])
    rng.shuffle(values)
    stream = b"".join(itf8_put(int(v)) for v in values)
    decoded, consumed = itf8_decode_vec(stream, values.shape[0])
    np.testing.assert_array_equal(decoded, values)
    assert consumed == len(stream)


def test_cram_to_bam_fast_path_matches_fallback(tmp_path, monkeypatch):
    """The vectorized slice->BAM-blob assembly must produce record-level
    identical output to the per-record fallback, on a CRAM with masked
    multi-TD tags, rg=-1 rows, empty reads and odd lengths."""
    from pheniqs_tpu.io import cram as cram_mod
    from pheniqs_tpu.io.cram import CramWriter, cram_to_bam
    from pheniqs_tpu.io.hts import read_bam

    rng = np.random.default_rng(23)
    n = 1500
    codes = np.array([1, 2, 4, 8, 15], np.uint8)
    lengths = rng.integers(0, 61, n).astype(np.int64)
    lengths[::97] = 0
    w = 61
    code = codes[rng.integers(5, size=(n, w))].astype(np.uint8)
    qual = rng.integers(2, 42, (n, w)).astype(np.uint8)
    names = [f"q{i}".encode() for i in range(n)]
    flags = np.where(rng.random(n) < 0.5, 0x4D, 0x8E).astype(np.int64)
    rg = np.where(rng.random(n) < 0.3, -1, rng.integers(0, 2, n))
    xb = rng.random(n).astype(np.float32)
    bc = np.frombuffer(b"ACGTACG" * n, np.uint8)[: n * 7].reshape(n, 7)
    bc_mask = rng.random(n) < 0.7
    fi = rng.integers(1, 4, n).astype(np.int32)
    fi_mask = rng.random(n) < 0.4

    path = tmp_path / "x.cram"
    with open(path, "wb") as stream:
        writer = CramWriter(stream, HEADER, level=4)
        writer.write_batch(
            names, flags, code, qual, lengths, rg,
            [
                (b"BC", "Z", bc, bc_mask),
                (b"XB", "f", xb, None),
                (b"FI", "i", fi, fi_mask),
            ],
        )
        writer.close()

    fast = tmp_path / "fast.bam"
    assert cram_to_bam(str(path), str(fast)) == n
    slow = tmp_path / "slow.bam"
    monkeypatch.setattr(
        cram_mod, "_slice_to_bam_blob",
        lambda *args, **kwargs: None,
    )
    assert cram_to_bam(str(path), str(slow)) == n

    got = list(read_bam(str(fast)))
    want = list(read_bam(str(slow)))
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.name == b.name
        assert a.flag == b.flag
        assert a.aux == b.aux
        np.testing.assert_array_equal(a.code, b.code)
        np.testing.assert_array_equal(a.quality, b.quality)
        assert (a.ref_id, a.pos, a.next_ref, a.next_pos, a.tlen) == (
            b.ref_id, b.pos, b.next_ref, b.next_pos, b.tlen
        )


# --- rANS 4x8 --------------------------------------------------------------

from pheniqs_tpu.io.rans import rans_compress, rans_uncompress


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize(
    "payload",
    [
        b"",
        b"A",
        b"ACG",
        b"ACGT",
        b"AAAAAAAA",
        b"ACGTACGTACGTACGTN" * 100,
        bytes(range(256)) * 3,
        np.random.default_rng(3).integers(0, 256, size=10001)
        .astype(np.uint8).tobytes(),
        np.random.default_rng(5).choice(
            np.frombuffer(b"FFFFF:III,#", dtype=np.uint8), size=40003
        ).tobytes(),
    ],
    ids=["empty", "one", "three", "four", "const", "acgt", "all-bytes",
         "uniform", "phred-like"],
)
def test_rans_round_trip(order, payload):
    stream = rans_compress(payload, order=order)
    assert rans_uncompress(stream) == payload


def test_rans_compresses_skewed_data():
    """Order-1 beats gzip-like entropy on quality-score-like data."""
    rng = np.random.default_rng(11)
    payload = rng.choice(
        np.frombuffer(b"FFFFFFFFFF:I", dtype=np.uint8), size=100000
    ).tobytes()
    stream = rans_compress(payload, order=1)
    assert len(stream) < len(payload) // 2
    assert rans_uncompress(stream) == payload


def test_cram_rans_blocks_round_trip(tmp_path, monkeypatch):
    """PHENIQS_CRAM_RANS=1 writes BA/QS as method-4 blocks; the reader
    recovers identical records."""
    monkeypatch.setenv("PHENIQS_CRAM_RANS", "1")
    records = synthetic_records(300, seed=23)
    path = tmp_path / "r.cram"
    with open(path, "wb") as stream:
        writer = CramWriter(stream, HEADER, level=5)
        for record in records:
            writer.write_record(*record)
        writer.close()
    raw = path.read_bytes()
    assert raw.count(b"\x04\x04") >= 1  # method=4 external blocks present
    got = list(read_cram(str(path)))
    assert len(got) == len(records)
    for mine, (name, flag, code, qual, length, tags) in zip(got, records):
        assert mine.name == name.encode()
        np.testing.assert_array_equal(mine.code, code[:length])
        np.testing.assert_array_equal(mine.quality, qual[:length])


@pytest.mark.parametrize("order", [0, 1])
def test_rans_native_python_interop(order, monkeypatch):
    """The native and pure-Python rANS coders share a wire format: each
    must decode the other's streams."""
    from pheniqs_tpu.io import rans as rans_mod
    from pheniqs_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    payload = rng.choice(
        np.frombuffer(b"ACGGGGTTTNAC", dtype=np.uint8), size=50001
    ).tobytes()

    native_stream = native.rans_compress(payload, order)
    python_stream = (
        rans_mod._compress_o1(payload) if order else rans_mod._compress_o0(payload)
    )
    import struct as _struct
    python_stream = (
        _struct.pack("<BII", order, len(python_stream), len(payload))
        + python_stream
    )

    # python decode of native stream
    po = int(native_stream[0])
    raw = (
        rans_mod._uncompress_o1(native_stream, 9, len(payload))
        if po else rans_mod._uncompress_o0(native_stream, 9, len(payload))
    )
    assert raw == payload
    # native decode of python stream
    assert native.rans_uncompress(python_stream, len(payload)) == payload


def test_cram_interleaved_multisegment_input(tmp_path):
    """Paired records in one CRAM group into 2-segment reads through
    hts_read_batches (flags-driven total_segments), same as BAM."""
    from pheniqs_tpu.io.hts import hts_read_batches
    from pheniqs_tpu.io.sam import AuxTags

    path = tmp_path / "pairs.cram"
    rng = np.random.default_rng(3)
    with open(path, "wb") as stream:
        writer = CramWriter(stream, "@HD\tVN:1.0\n", level=5)
        for i in range(50):
            for flag in (0x4D, 0x8E):  # paired first / paired last, unmapped
                code = np.array([1, 2, 4, 8] * 8, dtype=np.uint8)
                qual = rng.integers(2, 40, size=32).astype(np.uint8)
                writer.write_record(f"pair{i}", flag, code, qual, 32, AuxTags())
        writer.close()

    batches = list(hts_read_batches(str(path), "cram", 32))
    total = sum(batch.size for batch in batches)
    assert total == 50
    for batch in batches:
        assert len(batch.segments) == 2


# --- crafted/adversarial rANS streams (advisor round-1 findings) -----------
# A decoder must fail typed on malformed tables: RLE runs walking the
# symbol/context index past 255, frequencies not summing to TOTFREQ,
# truncation inside a table, or a raw-size header inconsistent with the
# container — none may read or write out of bounds.


def _crafted_rle_overflow() -> bytes:
    # order-0; table: sym=2 freq=1, then RLE run of 255 starting at 3 —
    # walks the symbol index past 255 in a naive parser
    table = bytes([2, 0x01, 3, 255]) + bytes([0x01] * 50) + bytes([0])
    payload = table + b"\x00" * 16 + b"\xff" * 32
    return struct.pack("<BII", 0, len(payload), 64) + payload


def _crafted_fat_frequencies() -> bytes:
    # order-0; two symbols each with frequency 0x7FFF: sum ~8M >> TOTFREQ,
    # would overflow the 4096-entry slot lookup if unvalidated
    table = bytes([1, 0xFF, 0xFF, 2, 0xFF, 0xFF, 0])
    payload = table + b"\x00" * 16 + b"\xff" * 32
    return struct.pack("<BII", 0, len(payload), 64) + payload


@pytest.mark.parametrize(
    "stream",
    [
        _crafted_rle_overflow(),
        _crafted_fat_frequencies(),
        struct.pack("<BII", 0, 4, 100) + b"\x05\x01",  # truncated table
        struct.pack("<BII", 1, 4, 100) + b"\x00\x05",  # truncated o1 contexts
        struct.pack("<BII", 7, 0, 8) + b"\x00" * 8,  # unknown order
    ],
)
@pytest.mark.parametrize("native_path", [False, True])
def test_rans_crafted_streams_fail_typed(stream, native_path, monkeypatch):
    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu import native

    if native_path and not native.available():
        pytest.skip("native library unavailable")
    if not native_path:
        monkeypatch.setenv("PHENIQS_NATIVE", "0")
    with pytest.raises(IOError_):
        rans_uncompress(stream)


def test_rans_expected_size_rejects_flipped_header():
    """The container's declared raw size gates the allocation: a stream
    claiming 4GB against a 10-byte block must be rejected up front."""
    from pheniqs_tpu.errors import IOError_

    stream = rans_compress(b"ACGTACGTAC", order=0)
    forged = stream[:5] + struct.pack("<I", 0xF0000000) + stream[9:]
    with pytest.raises(IOError_):
        rans_uncompress(forged, expected_size=10)
    # and the unforged stream still round-trips under the same gate
    assert rans_uncompress(stream, expected_size=10) == b"ACGTACGTAC"


def test_mapped_bam_cram_bam_round_trip(tmp_path):
    """Mapped records transcode BAM -> CRAM (reference-based read
    features) -> BAM with alignment placement, CIGAR, sequence, quality
    and aux preserved (the htslib workflow at reference hts.cpp:160-240)."""
    import numpy as np

    from pheniqs_tpu.io.cram import bam_to_cram, cram_to_bam, read_cram
    from pheniqs_tpu.io.hts import BamWriter, HtsRecord, read_bam
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    rng = np.random.default_rng(77)
    ref1 = "".join(rng.choice(list("ACGT"), size=500))
    ref2 = "".join(rng.choice(list("ACGT"), size=300))
    fasta = tmp_path / "ref.fa"
    fasta.write_text(f">chr1\n{ref1}\n>chr2\n{ref2}\n")

    header = (
        "@HD\tVN:1.6\tSO:coordinate\n"
        f"@SQ\tSN:chr1\tLN:{len(ref1)}\n"
        f"@SQ\tSN:chr2\tLN:{len(ref2)}\n"
        "@RG\tID:rg0\tSM:s\n"
    )

    def rec(name, ref_id, pos, cigar, seq, mapq=37, flag=0, aux=None,
            next_ref=-1, next_pos=-1, tlen=0):
        code = ASCII_TO_BAM[np.frombuffer(seq.encode(), dtype=np.uint8)]
        qual = rng.integers(10, 40, size=len(seq)).astype(np.uint8)
        return HtsRecord(
            name.encode(), flag, code, qual, aux or {},
            ref_id=ref_id, pos=pos, mapq=mapq, cigar=cigar,
            next_ref=next_ref, next_pos=next_pos, tlen=tlen,
        )

    # perfect match
    r0 = rec("match", 0, 10, [("M", 40)], ref1[10:50])
    # substitutions (two mismatches)
    seq1 = list(ref1[100:140])
    seq1[5] = "A" if seq1[5] != "A" else "G"
    seq1[20] = "T" if seq1[20] != "T" else "C"
    r1 = rec("subst", 0, 100, [("M", 40)], "".join(seq1),
             aux={"NM": 2, "XB": 0.25, "CO": "hello"})
    # soft clip + insertion + deletion + skip
    seq2 = "ACGTA" + ref1[200:220] + "GGGG" + ref1[220:240]
    r2 = rec("indel", 0, 200,
             [("S", 5), ("M", 20), ("I", 4), ("M", 20)], seq2)
    r3 = rec("deleted", 1, 50, [("M", 10), ("D", 7), ("M", 10)],
             ref2[50:60] + ref2[67:77])
    r4 = rec("skipped", 1, 100, [("M", 8), ("N", 30), ("M", 8)],
             ref2[100:108] + ref2[138:146])
    # ambiguity base inside an aligned run -> B feature
    seq5 = list(ref2[10:30])
    seq5[3] = "N"
    seq5[9] = "R"
    r5 = rec("ambig", 1, 10, [("M", 20)], "".join(seq5))
    # hard clip + mate fields + paired flags
    r6 = rec("mate", 0, 300, [("H", 3), ("M", 25)], ref1[300:325],
             flag=0x1 | 0x20, next_ref=0, next_pos=400, tlen=125,
             aux={"RG": "rg0"})
    # unmapped record in the same stream
    r7 = rec("unmapped", -1, -1, None, "ACGTACGTNN", mapq=0, flag=0x4)

    records = [r0, r1, r2, r3, r4, r5, r6, r7]
    bam1 = tmp_path / "in.bam"
    with open(bam1, "wb") as stream:
        writer = BamWriter(
            stream, header, references=[("chr1", len(ref1)), ("chr2", len(ref2))]
        )
        for record in records:
            writer.write_hts_record(record)
        writer.close()

    cram = tmp_path / "mid.cram"
    n = bam_to_cram(str(bam1), str(cram), str(fasta))
    assert n == len(records)

    # sanity: mapped records really are feature-coded (the CRAM must be
    # smaller than raw sequence storage would make it, and decoding
    # without a reference must fail typed)
    import pytest

    from pheniqs_tpu.errors import IOError_

    with pytest.raises(IOError_):
        list(read_cram(str(cram), reference=None))

    bam2 = tmp_path / "out.bam"
    n2 = cram_to_bam(str(cram), str(bam2), str(fasta))
    assert n2 == len(records)

    first = list(read_bam(str(bam1)))
    second = list(read_bam(str(bam2)))
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert a.name == b.name
        assert a.flag == b.flag
        assert a.ref_id == b.ref_id
        assert a.pos == b.pos
        assert a.mapq == b.mapq
        assert a.cigar == b.cigar
        np.testing.assert_array_equal(a.code, b.code)
        np.testing.assert_array_equal(a.quality, b.quality)
        assert a.next_ref == b.next_ref
        assert a.next_pos == b.next_pos
        assert a.tlen == b.tlen
        for key, value in a.aux.items():
            if isinstance(value, float):
                assert abs(b.aux[key] - value) < 1e-6, key
            else:
                assert b.aux.get(key) == value, key


def test_write_batch_byte_identical_to_write_record(tmp_path):
    """The vectorized columnar intake must produce the exact bytes of the
    per-record path when every record carries the same tag layout (one TD
    line), across a slice boundary."""
    import io

    n = 5000  # > RECORDS_PER_SLICE, exercises the second container
    rng = np.random.default_rng(11)
    w = 36
    lengths = rng.integers(20, w + 1, size=n).astype(np.int64)
    alphabet = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    codes = alphabet[rng.integers(len(alphabet), size=(n, w))]
    quals = rng.integers(2, 42, size=(n, w)).astype(np.uint8)
    names = [b"M02455:162:1:%d" % i for i in range(n)]
    flags = np.where(np.arange(n) % 2 == 0, 0x4D, 0x8E).astype(np.int64)
    rg_names = ["BDGGG:1:AGGCATG", "undetermined"]
    rg = (np.arange(n) % 2).astype(np.int64)
    bc = np.frombuffer(b"AGGCATG" * n, dtype=np.uint8).reshape(n, 7).copy()
    qt = [b"IIIIIII"] * n
    xb = (rng.random(n) * 0.5).astype(np.float32)

    ref = io.BytesIO()
    writer = CramWriter(ref, HEADER, 5)
    for i in range(n):
        tags = AuxTags()
        tags.RG = rg_names[i % 2]
        tags.BC = "AGGCATG"
        tags.QT = "IIIIIII"
        tags.XB = float(xb[i])
        writer.write_record(
            names[i].decode(), int(flags[i]), codes[i], quals[i],
            int(lengths[i]), tags,
        )
    writer.close()

    got = io.BytesIO()
    writer = CramWriter(got, HEADER, 5)
    writer.write_batch(
        names, flags, codes, quals, lengths, rg,
        [(b"BC", "Z", bc), (b"QT", "Z", qt), (b"XB", "f", xb)],
    )
    writer.close()
    assert got.getvalue() == ref.getvalue()

    path = tmp_path / "batch.cram"
    path.write_bytes(got.getvalue())
    back = list(read_cram(str(path)))
    assert len(back) == n
    for i in (0, 1, 4095, 4096, n - 1):
        record = back[i]
        name = record.name
        if isinstance(name, bytes):
            name = name.decode()
        assert name == names[i].decode()
        assert record.flag == int(flags[i]) | 0x4
        np.testing.assert_array_equal(
            record.code[: lengths[i]], codes[i, : lengths[i]]
        )
        np.testing.assert_array_equal(
            record.quality[: lengths[i]], quals[i, : lengths[i]]
        )
        assert record.aux["BC"] == "AGGCATG"
        assert abs(record.aux["XB"] - float(xb[i])) < 1e-7
        assert record.aux["RG"] == rg_names[i % 2]


def test_flush_simple_byte_identical_to_general(tmp_path):
    """The columnar demux-slice assembly (_flush_simple) must produce the
    exact bytes of the general per-record loop, including mixed tag
    layouts (two TD lines) and a slice boundary."""
    import io

    def build(force_general: bool) -> bytes:
        out = io.BytesIO()
        writer = CramWriter(out, HEADER, 5)
        if force_general:
            writer._flush_simple = writer._flush_general
        rng = np.random.default_rng(23)
        for i in range(5000):
            code = np.array([1, 2, 4, 8] * 9, dtype=np.uint8)
            qual = rng.integers(2, 42, size=36).astype(np.uint8)
            tags = AuxTags()
            tags.RG = "BDGGG:1:AGGCATG" if i % 3 else "undetermined"
            tags.BC = "AGGCATG"
            tags.QT = "IIIIIII"
            if i % 5 == 0:
                tags.XB = 0.25  # different tag layout -> second TD line
            writer.write_record(
                f"M02455:162:1:{i}", 0x4D if i % 2 else 0x8E,
                code, qual, 30 + (i % 7), tags,
            )
        writer.close()
        return out.getvalue()

    fast = build(False)
    general = build(True)
    assert fast == general


def test_long_z_tag_batch_write_uses_multibyte_itf8(tmp_path):
    """A Z-tag column 127+ chars wide needs a 2-byte ITF-8 length prefix;
    the single-byte fast path would emit a high-bit byte that mis-frames
    every later value in the slice (regression: round-3 review)."""
    import io

    n = 64
    w = 150  # value length 151 incl. NUL -> 2-byte ITF-8
    rng = np.random.default_rng(5)
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)[
        rng.integers(4, size=(n, 36))
    ]
    quals = rng.integers(2, 42, size=(n, 36)).astype(np.uint8)
    lengths = np.full(n, 36, dtype=np.int64)
    names = [b"r%05d" % i for i in range(n)]
    flags = np.full(n, 0x4D, dtype=np.int64)
    rg = np.zeros(n, dtype=np.int64)
    long_vals = np.frombuffer(
        bytes(((i + j) % 26) + 65 for i in range(n) for j in range(w)),
        dtype=np.uint8,
    ).reshape(n, w).copy()

    out = io.BytesIO()
    writer = CramWriter(out, HEADER, 5)
    writer.write_batch(
        names, flags, codes, quals, lengths, rg,
        [(b"CB", "Z", long_vals)],
    )
    writer.close()
    path = tmp_path / "longz.cram"
    path.write_bytes(out.getvalue())
    back = list(read_cram(str(path)))
    assert len(back) == n
    for i in (0, 1, n - 1):
        assert back[i].aux["CB"] == long_vals[i].tobytes().decode()


def test_read_cram_header_beyond_probe_size(tmp_path):
    """SAM headers can exceed any fixed probe (draft genomes carry
    multi-MB @SQ dictionaries): read_cram_header must read through the
    whole header container (regression: round-3 review)."""
    import io

    from pheniqs_tpu.io.cram import read_cram_header

    sq = "".join(
        f"@SQ\tSN:scaffold_{i:06d}\tLN:{1000 + i}\n" for i in range(4000)
    )
    big_header = "@HD\tVN:1.6\tSO:unknown\n" + sq
    assert len(big_header) > (1 << 16)

    out = io.BytesIO()
    writer = CramWriter(out, big_header, 5)
    code = np.array([1, 2, 4, 8], dtype=np.uint8)
    writer.write_record("r0", 0x4, code, np.full(4, 30, np.uint8), 4, AuxTags())
    writer.close()
    path = tmp_path / "bigheader.cram"
    path.write_bytes(out.getvalue())

    text, references = read_cram_header(str(path))
    assert text == big_header
    assert len(references) == 4000
    assert references[0] == ("scaffold_000000", 1000)
    assert references[-1] == ("scaffold_003999", 4999)


def test_write_batch_masked_tags_byte_identical_to_per_record(tmp_path):
    """Optional tags (per-column presence masks) must produce the same
    multi-line TD dictionary and per-record TL indices as the per-record
    path — byte for byte — and round-trip through the reader."""
    import io

    n = 4000
    rng = np.random.default_rng(13)
    w = 36
    lengths = np.full(n, w, dtype=np.int64)
    alphabet = np.array([1, 2, 4, 8], dtype=np.uint8)
    codes = alphabet[rng.integers(len(alphabet), size=(n, w))]
    quals = rng.integers(2, 42, size=(n, w)).astype(np.uint8)
    names = [b"r%06d" % i for i in range(n)]
    flags = np.full(n, 0x4D, dtype=np.int64)
    rg = np.zeros(n, dtype=np.int64)
    bc = np.frombuffer(b"AGGCATG" * n, dtype=np.uint8).reshape(n, 7).copy()
    xb = (rng.random(n) * 0.5).astype(np.float32)
    # three layouts: both tags, only BC, neither
    has_bc = (np.arange(n) % 3) != 2
    has_xb = (np.arange(n) % 3) == 0

    ref = io.BytesIO()
    writer = CramWriter(ref, HEADER, 5)
    for i in range(n):
        tags = AuxTags()
        tags.RG = "BDGGG:1:AGGCATG"
        if has_bc[i]:
            tags.BC = "AGGCATG"
        if has_xb[i]:
            tags.XB = float(xb[i])
        writer.write_record(
            names[i].decode(), int(flags[i]), codes[i], quals[i],
            int(lengths[i]), tags,
        )
    writer.close()

    got = io.BytesIO()
    writer = CramWriter(got, HEADER, 5)
    writer.write_batch(
        names, flags, codes, quals, lengths, rg,
        [
            (b"BC", "Z", bc, has_bc),
            (b"XB", "f", xb, has_xb),
        ],
    )
    writer.close()
    assert got.getvalue() == ref.getvalue()

    path = tmp_path / "masked.cram"
    path.write_bytes(got.getvalue())
    back = list(read_cram(str(path)))
    assert len(back) == n
    for i in (0, 1, 2, 3998, 3999):
        aux = back[i].aux
        assert ("BC" in aux) == bool(has_bc[i])
        assert ("XB" in aux) == bool(has_xb[i])
        if has_xb[i]:
            assert abs(aux["XB"] - float(xb[i])) < 1e-7


def test_columnar_cram_demux_byte_identical_to_per_record(
    reference_root, tmp_path
):
    """On a slice-aligned run (250 BDGGG reads = one engine batch = one
    slice) the columnar CRAM route must reproduce the per-record path's
    bytes exactly — multi-line TD dictionary, slice-local tag CIDs,
    per-record TL indices and all."""
    out = tmp_path / "out.cram"

    def run(env_extra):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update(env_extra)
        subprocess.run(
            [
                sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
                "--config",
                os.path.join(reference_root, "test/BDGGG/BDGGG_annotated.json"),
                "--precision", "15", "--threads", "1",
                "--output", str(out), "--report", "/dev/null",
            ],
            cwd=str(reference_root), check=True, capture_output=True, env=env,
        )
        return out.read_bytes()

    columnar = run({})
    fallback = run({"PHENIQS_BAM_COLUMNS": "0"})
    assert columnar == fallback
    assert len(list(read_cram(str(out)))) == 496


def test_write_batch_masked_multislice_round_trip(tmp_path):
    """Random per-column masks across multiple slices (10k records >
    RECORDS_PER_SLICE): per-slice TD dictionaries must decode every
    record's tag presence and values exactly, including slices where a
    layout or a whole tag never occurs."""
    import io

    n = 10000
    rng = np.random.default_rng(29)
    w = 24
    lengths = np.full(n, w, dtype=np.int64)
    alphabet = np.array([1, 2, 4, 8], dtype=np.uint8)
    codes = alphabet[rng.integers(len(alphabet), size=(n, w))]
    quals = rng.integers(2, 42, size=(n, w)).astype(np.uint8)
    names = [b"q%06d" % i for i in range(n)]
    flags = np.full(n, 0x4D, dtype=np.int64)
    rg = np.full(n, -1, dtype=np.int64)
    bc = np.frombuffer(b"TGCAGAT" * n, dtype=np.uint8).reshape(n, 7).copy()
    xb = (rng.random(n) * 0.5 + 0.25).astype(np.float32)
    fi = rng.integers(1, 4, size=n).astype(np.int32)
    has_bc = rng.random(n) < 0.8
    has_xb = rng.random(n) < 0.5
    # confine XB to the first slice so later slices lack the key entirely
    has_xb[4096:] = False

    out = io.BytesIO()
    writer = CramWriter(out, HEADER, 5)
    writer.write_batch(
        names, flags, codes, quals, lengths, rg,
        [
            (b"FI", "i", fi),
            (b"BC", "Z", bc, has_bc),
            (b"XB", "f", xb, has_xb),
        ],
    )
    writer.close()
    path = tmp_path / "multislice.cram"
    path.write_bytes(out.getvalue())
    back = list(read_cram(str(path)))
    assert len(back) == n
    check = list(range(0, 40)) + [4095, 4096, 4097, 8191, 8192, n - 1]
    for i in check:
        aux = back[i].aux
        assert aux["FI"] == int(fi[i])
        assert ("BC" in aux) == bool(has_bc[i])
        assert ("XB" in aux) == bool(has_xb[i])
        if has_bc[i]:
            assert aux["BC"] == "TGCAGAT"
        if has_xb[i]:
            assert abs(aux["XB"] - float(xb[i])) < 1e-7


def _aux_block_of(body: bytes) -> bytes:
    """The raw aux bytes of a BAM record body."""
    (
        _ref, _pos, l_read_name, _mapq, _bin, n_cigar, _flag,
        l_seq, _nref, _npos, _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    offset = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
    return body[offset:]


def test_transcode_preserves_aux_types_and_arrays(tmp_path):
    """BAM->CRAM->BAM keeps the aux block byte-identical: 'B' arrays,
    'A' chars, small-int widths ('c'/'s'/'S'), floats, and missing
    qualities (all-0xFF) all survive (ADVICE r3: the dict re-encode
    dropped arrays, retyped 'A' as 'Z' and widened ints)."""
    from pheniqs_tpu.io.cram import bam_to_cram, cram_to_bam
    from pheniqs_tpu.io.hts import HtsRecord, iter_bam_record_bodies

    raw_tags = [
        (b"XAA", b"Q"),                                   # char
        (b"XBB", b"c" + struct.pack("<I", 3) + b"\x01\xfe\x7f"),  # array
        (b"XCc", struct.pack("<b", -5)),                  # int8
        (b"XSs", struct.pack("<h", -300)),                # int16
        (b"XUS", struct.pack("<H", 40000)),               # uint16
        (b"XFf", struct.pack("<f", 0.25)),                # float
        (b"XZZ", b"hello\x00"),                           # string
        (b"XIB", b"I" + struct.pack("<I", 2)
         + struct.pack("<II", 7, 1 << 31)),               # uint32 array
    ]
    code = np.array([1, 2, 4, 8], dtype=np.uint8)
    records = [
        HtsRecord(b"r0", 0x4, code, np.array([30, 31, 32, 33], np.uint8),
                  {"RG": "BDGGG:1:AGGCATG"}, raw_tags=raw_tags),
        # missing-quality sentinel: all 0xFF must round-trip
        HtsRecord(b"r1", 0x4, code, np.full(4, 0xFF, np.uint8),
                  {}, raw_tags=[(b"NMi", struct.pack("<i", 2))]),
    ]
    bam1 = tmp_path / "in.bam"
    with open(bam1, "wb") as stream:
        writer = BamWriter(stream, HEADER, 5)
        for record in records:
            writer.write_hts_record(record)
        writer.close()
    cram = tmp_path / "mid.cram"
    assert bam_to_cram(str(bam1), str(cram)) == 2
    bam2 = tmp_path / "out.bam"
    assert cram_to_bam(str(cram), str(bam2)) == 2

    first = list(iter_bam_record_bodies(str(bam1)))
    second = list(iter_bam_record_bodies(str(bam2)))
    assert len(first) == len(second) == 2
    for a, b in zip(first, second):
        assert _aux_block_of(bytes(a)) == _aux_block_of(bytes(b))
    # and the quality sentinel survived verbatim
    back = list(read_bam(str(bam2)))
    np.testing.assert_array_equal(
        back[1].quality, np.full(4, 0xFF, np.uint8)
    )


def test_transcode_preserves_placed_unmapped(tmp_path):
    """Placed-unmapped records (FLAG_UNMAPPED with valid coordinates —
    unmapped mates in coordinate-sorted BAMs) keep ref_id/pos through
    BAM->CRAM->BAM via the multi-ref RI/AP series (ADVICE r3: the old
    gate silently dropped them to -1/-1)."""
    from pheniqs_tpu.io.cram import bam_to_cram, cram_to_bam, read_cram

    header = (
        "@HD\tVN:1.6\tSO:coordinate\n"
        "@SQ\tSN:chr1\tLN:1000\n"
    )
    from pheniqs_tpu.io.hts import HtsRecord

    code = np.array([1, 2, 4, 8], dtype=np.uint8)
    qual = np.array([30, 31, 32, 33], dtype=np.uint8)
    placed = HtsRecord(
        b"placed", 0x1 | 0x4 | 0x40, code, qual, {},
        ref_id=0, pos=141, next_ref=0, next_pos=141, tlen=0,
    )
    plain = HtsRecord(b"plain", 0x4, code, qual, {})
    bam1 = tmp_path / "in.bam"
    with open(bam1, "wb") as stream:
        writer = BamWriter(
            stream, header, references=[("chr1", 1000)]
        )
        writer.write_hts_record(placed)
        writer.write_hts_record(plain)
        writer.close()
    cram = tmp_path / "mid.cram"
    assert bam_to_cram(str(bam1), str(cram)) == 2
    got = list(read_cram(str(cram)))
    assert got[0].ref_id == 0 and got[0].pos == 141
    assert got[0].flag & 0x4
    assert got[1].ref_id == -1 and got[1].pos == -1
    bam2 = tmp_path / "out.bam"
    assert cram_to_bam(str(cram), str(bam2)) == 2
    back = list(read_bam(str(bam2)))
    assert back[0].ref_id == 0 and back[0].pos == 141
    assert back[0].next_ref == 0 and back[0].next_pos == 141
    assert back[1].ref_id == -1 and back[1].pos == -1


def test_cram_writer_rejects_contradictory_mapped_flag(tmp_path):
    """A record whose flag says mapped but whose coordinates say not
    cannot be represented (the reader branches on the flag alone and
    would expect a feature series): typed error, not stream desync."""
    import io

    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu.io.hts import HtsRecord

    writer = CramWriter(io.BytesIO(), HEADER, level=5)
    bad = HtsRecord(
        b"bad", 0x0, np.array([1], np.uint8), np.array([30], np.uint8), {},
        ref_id=-1, pos=-1,
    )
    with pytest.raises(IOError_):
        writer.write_hts_record(bad)


def test_bam_reader_rejects_implausible_block_size(tmp_path):
    """A corrupt/negative record length fails typed instead of walking
    the buffer backwards or allocating unbounded memory."""
    import gzip as _gzip

    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu.io.hts import iter_bam_record_bodies

    body = (
        b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
        + struct.pack("<i", -8)
    )
    path = tmp_path / "corrupt.bam"
    path.write_bytes(_gzip.compress(body))
    with pytest.raises(IOError_):
        list(iter_bam_record_bodies(str(path)))


def test_mapped_fast_path_matches_fallback(tmp_path, monkeypatch):
    """The vectorized mapped-slice transcode must produce the same BAM
    records as the per-record decoder (byte-identity checked on decoded
    record fields; the container framing may batch differently)."""
    from pheniqs_tpu.io import cram as cram_mod
    from pheniqs_tpu.io.cram import bam_to_cram, cram_to_bam
    from pheniqs_tpu.io.hts import HtsRecord, iter_bam_record_bodies
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    rng = np.random.default_rng(7)
    ref1 = "".join(rng.choice(list("ACGT"), size=4000))
    fasta = tmp_path / "ref.fa"
    fasta.write_text(f">chr1\n{ref1}\n")
    header = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:4000\n@RG\tID:rg0\tSM:s\n"

    def rec(name, pos, cigar, seq, flag=0, aux=None):
        code = ASCII_TO_BAM[np.frombuffer(seq.encode(), dtype=np.uint8)]
        qual = rng.integers(10, 40, size=len(seq)).astype(np.uint8)
        return HtsRecord(name.encode(), flag, code, qual, aux or {},
                         ref_id=0, pos=pos, mapq=37, cigar=cigar)

    records = []
    for i in range(500):
        pos = int(rng.integers(0, 3000))
        kind = i % 5
        if kind == 0:  # perfect
            records.append(rec(f"m{i}", pos, [("M", 40)], ref1[pos:pos+40],
                               aux={"NM": 0}))
        elif kind == 1:  # substitutions
            seq = list(ref1[pos:pos+40])
            seq[7] = "A" if seq[7] != "A" else "G"
            seq[23] = "T" if seq[23] != "T" else "C"
            records.append(rec(f"x{i}", pos, [("M", 40)], "".join(seq),
                               aux={"NM": 2}))
        elif kind == 2:  # soft clip + insertion
            seq = "TTTT" + ref1[pos:pos+20] + "GGG" + ref1[pos+20:pos+36]
            records.append(rec(f"s{i}", pos,
                               [("S", 4), ("M", 20), ("I", 3), ("M", 16)], seq))
        elif kind == 3:  # deletion + skip
            seq = ref1[pos:pos+12] + ref1[pos+17:pos+29] + ref1[pos+59:pos+69]
            records.append(rec(f"d{i}", pos,
                               [("M", 12), ("D", 5), ("M", 12), ("N", 30),
                                ("M", 10)], seq))
        else:  # unmapped in the same stream
            records.append(HtsRecord(
                f"u{i}".encode(), 0x4,
                ASCII_TO_BAM[np.frombuffer(b"ACGTACGT", np.uint8)],
                rng.integers(10, 40, size=8).astype(np.uint8), {}))
    bam1 = tmp_path / "in.bam"
    with open(bam1, "wb") as stream:
        writer = BamWriter(stream, header, references=[("chr1", 4000)])
        for record in records:
            writer.write_hts_record(record)
        writer.close()
    cram = tmp_path / "mid.cram"
    assert bam_to_cram(str(bam1), str(cram), str(fasta)) == len(records)

    fast = tmp_path / "fast.bam"
    assert cram_to_bam(str(cram), str(fast), str(fasta)) == len(records)
    monkeypatch.setattr(
        cram_mod, "_mapped_slice_to_bam_blob",
        lambda *a, **k: None,
    )
    slow = tmp_path / "slow.bam"
    assert cram_to_bam(str(cram), str(slow), str(fasta)) == len(records)
    a = list(iter_bam_record_bodies(str(fast)))
    b = list(iter_bam_record_bodies(str(slow)))
    assert len(a) == len(b) == len(records)
    for x, y in zip(a, b):
        assert bytes(x) == bytes(y)


def test_out_of_domain_quality_classifies_safely(tmp_path):
    """HTS inputs can carry the BAM missing-quality sentinel (all 0xFF,
    '*' in SAM) or spec-invalid quality bytes >= 0x80. Classification
    ingest must normalize them (0xFF -> 0, clamp below 0x80, the f64
    substitution LUT domain) on EVERY path — the Python record stream,
    the native batch readers, and the CRAM batch reader — instead of
    crashing the oracle (IndexError) or reading out of bounds in the
    native classifier. Decisions must agree across paths."""
    import json

    from pheniqs_tpu.io.hts import BamWriter, HtsRecord
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    code = ASCII_TO_BAM[
        np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGTACGT", np.uint8)
    ]
    records = []
    for i in range(6):
        if i % 3 == 0:
            qual = np.full(32, 0xFF, np.uint8)  # missing sentinel
        elif i % 3 == 1:
            qual = np.full(32, 30, np.uint8)
            qual[5] = 0x90  # spec-invalid byte
        else:
            qual = np.full(32, 33, np.uint8)
        records.append(HtsRecord(b"r%d" % i, 0x4, code, qual, {}))

    bam = tmp_path / "ffqual.bam"
    with open(bam, "wb") as stream:
        writer = BamWriter(stream, "@HD\tVN:1.6\n")
        for record in records:
            writer.write_hts_record(record)
        writer.close()

    config = {
        "input": [str(bam)],
        "output": ["/dev/null"],
        "report url": "report.json",
        "template": {"transform": {"token": ["0::"]}},
        "sample": {
            "transform": {"token": ["0:0:8"]},
            "codec": {"@A": {"barcode": ["ACGTACGT"]}},
            "algorithm": "pamld",
            "noise": 0.05,
        },
    }
    path = tmp_path / "job.json"
    path.write_text(json.dumps(config))

    reports = {}
    for label, env in (
        ("native", {}),
        ("python", {"PHENIQS_NATIVE": "0"}),
    ):
        result = run_mux(
            str(tmp_path),
            ["--config", str(path), "--threads", "1"],
            extra_env=env,
        )
        assert result.returncode == 0, (label, result.stderr[-2000:])
        report = json.loads((tmp_path / "report.json").read_text())
        demux = report["sample"]
        reports[label] = (
            demux["count"],
            demux["classified count"],
            [b["count"] for b in demux.get("classified", [])],
        )
    assert reports["native"] == reports["python"], reports
    assert reports["native"][0] == 6  # every record counted
