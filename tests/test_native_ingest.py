"""Native C++ FASTQ parser vs the pure-Python reader: byte parity on
plain and gzip feeds, and batch assembly equivalence."""

import numpy as np
import pytest

from pheniqs_tpu.io.fastq import read_fastq
from pheniqs_tpu.iupac import ASCII_TO_BAM


@pytest.fixture(scope="module")
def native():
    from pheniqs_tpu import native as native_module

    if not native_module.available():
        pytest.skip(f"native library unavailable: {native_module.build_error()}")
    return native_module


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_native_reader_matches_python(native, bdggg, suffix):
    path = f"{bdggg}/BDGGG_s01.fastq{suffix}"
    reader = native.NativeFastqReader(path)
    records = list(read_fastq(path))
    parsed = 0
    while True:
        batch = reader.read_batch(1024)
        if batch is None:
            break
        code, qual, length, qcfail, blob, offsets = batch
        names = [
            blob[offsets[i] : offsets[i + 1]] for i in range(code.shape[0])
        ]
        for i in range(code.shape[0]):
            reference = records[parsed + i]
            n = len(reference.sequence)
            assert length[i] == n
            assert names[i] == reference.name
            assert (
                code[i, :n]
                == ASCII_TO_BAM[np.frombuffer(reference.sequence, np.uint8)]
            ).all()
            assert (qual[i, :n] == np.frombuffer(reference.quality, np.uint8)).all()
            assert bool(qcfail[i]) == reference.qcfail
        parsed += code.shape[0]
    assert parsed == len(records)


def test_native_batch_assembly(native, bdggg):
    from pheniqs_tpu.io.ingest import native_read_batches

    urls = [f"{bdggg}/BDGGG_s0{i}.fastq" for i in (1, 2, 3)]
    batches = list(native_read_batches(urls, 33, batch_size=100))
    assert sum(b.size for b in batches) == 250
    first = batches[0]
    assert first.segment_cardinality == 3
    assert first.segments[1].width == 8  # index segment
    assert first.names[0].startswith(b"M02455:")


def test_native_reader_malformed(native, tmp_path):
    from pheniqs_tpu.errors import SequenceError

    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@read1\nACGT\n+\nII\n")  # quality shorter than sequence
    reader = native.NativeFastqReader(str(bad))
    with pytest.raises(SequenceError):
        reader.read_batch(10)


def test_concat_spans(native):
    from pheniqs_tpu.native import concat_spans

    arenas = [b"HELLOWORLD", b"abcdef"]
    piece_arena = np.array([0, 1, 0], dtype=np.uint8)
    piece_start = np.array([0, 2, 5], dtype=np.int64)
    piece_len = np.array([5, 3, 5], dtype=np.int32)
    assert bytes(concat_spans(arenas, piece_arena, piece_start, piece_len)) == (
        b"HELLO" + b"cde" + b"WORLD"
    )


def test_fastq_format_batch(native):
    from pheniqs_tpu.iupac import ASCII_TO_BAM
    from pheniqs_tpu.native import fastq_format_batch

    names = b"read1read22"
    offsets = np.array([0, 5, 11], dtype=np.int64)
    code = ASCII_TO_BAM[
        np.frombuffer(b"ACGTNACGTN", dtype=np.uint8)
    ].reshape(2, 5)
    quality = np.tile(np.arange(30, 35, dtype=np.uint8), (2, 1))
    length = np.array([5, 4], dtype=np.int32)
    qcfail = np.array([0, 1], dtype=np.uint8)
    bc = (b"AAGG", np.array([0, 2], dtype=np.int64), np.array([2, 2], dtype=np.int32))

    arena, rec = fastq_format_batch(
        names, offsets, qcfail, 2, code, quality, length, 33, bc
    )
    records = bytes(arena).decode().rstrip("\n").split("\n")
    assert records[0] == "@read1 2:N:0:AA"
    assert records[1] == "ACGTN"
    assert records[2] == "+"
    assert records[3] == chr(63) + chr(64) + chr(65) + chr(66) + chr(67)
    assert records[4] == "@read22 2:Y:0:GG"
    assert records[5] == "ACGT"
    assert rec[2] == len(arena)

    # comment omitted entirely for non-Illumina platforms
    arena2, _ = fastq_format_batch(
        names, offsets, qcfail, 0, code, quality, length, 33, None
    )
    assert bytes(arena2).decode().split("\n")[0] == "@read1"


def test_overlong_read_grows_not_truncates(native, tmp_path):
    """A record longer than the reader's matrix width must be returned in
    full (the reference handles arbitrary read lengths) — round 1 clipped
    the data but reported the full length, corrupting downstream output."""
    long_seq = b"ACGT" * 600  # 2400 bases, far beyond the 8-wide matrices
    long_qual = b"I" * 2400
    path = tmp_path / "long.fastq"
    path.write_bytes(
        b"@short1 1:N:0:AA\nACGTACGT\n+\nIIIIIIII\n"
        b"@verylong 1:N:0:AA\n" + long_seq + b"\n+\n" + long_qual + b"\n"
        b"@short2 1:N:0:AA\nTTTTCCCC\n+\nIIIIIIII\n"
    )
    reader = native.NativeFastqReader(str(path), max_length=8)
    seen = []
    while True:
        batch = reader.read_batch(16)
        if batch is None:
            break
        code, qual, length, qcfail, blob, offsets = batch
        for i in range(code.shape[0]):
            n = int(length[i])
            assert n <= code.shape[1]  # length never exceeds matrix width
            seen.append((blob[offsets[i]:offsets[i + 1]], code[i, :n].copy()))
    reader.close()
    assert [name for name, _ in seen] == [b"short1", b"verylong", b"short2"]
    expected = ASCII_TO_BAM[np.frombuffer(long_seq, np.uint8)]
    assert (seen[1][1] == expected).all()
    assert (
        seen[2][1] == ASCII_TO_BAM[np.frombuffer(b"TTTTCCCC", np.uint8)]
    ).all()


def test_tiny_batch_size_names_arena(native, bdggg):
    """batch sizes below 16 used to fail immediately: the 4096-byte name
    headroom exceeded the max_records*256 arena."""
    reader = native.NativeFastqReader(f"{bdggg}/BDGGG_s01.fastq")
    batch = reader.read_batch(10)
    assert batch is not None
    assert batch[0].shape[0] == 10
    reader.close()


def test_parallel_bgzf_input(native, tmp_path):
    """BGZF-framed gzip input decompresses on the native block pool and
    parses identically to plain text (round 2: reference
    transcode.cpp:1599-1605 dedicates an htslib thread pool to this)."""
    from pheniqs_tpu.io.hts import BgzfWriter
    from pheniqs_tpu.native import open_bgzf

    payload = b"".join(
        b"@r%d 1:N:0:AA\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n" % i
        for i in range(50000)
    )
    path = tmp_path / "reads.fastq.gz"
    with open(path, "wb") as raw:
        writer = BgzfWriter(raw, 5)
        writer.write(payload)
        writer.close()

    handle = open_bgzf(str(path))
    assert handle is not None  # detected as BGZF
    data = bytearray()
    while True:
        chunk = handle.read(1 << 18)
        if not chunk:
            break
        data += chunk
    handle.close()
    assert bytes(data) == payload

    reader = native.NativeFastqReader(str(path), max_length=32)
    parsed = 0
    while True:
        batch = reader.read_batch(16384)
        if batch is None:
            break
        parsed += batch[0].shape[0]
    reader.close()
    assert parsed == 50000


def test_bgzf_corrupt_block_fails_typed(native, tmp_path):
    from pheniqs_tpu.io.hts import BgzfWriter
    from pheniqs_tpu.errors import IOError_
    from pheniqs_tpu.native import open_bgzf

    path = tmp_path / "corrupt.gz"
    with open(path, "wb") as raw:
        writer = BgzfWriter(raw, 5)
        writer.write(b"@r0\nACGT\n+\nIIII\n" * 5000)
        writer.close()
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF  # flip a byte inside a compressed block
    path.write_bytes(bytes(blob))

    handle = open_bgzf(str(path))
    assert handle is not None
    with pytest.raises(IOError_):
        while handle.read(1 << 18):
            pass
    handle.close()


def test_native_bam_ingest_matches_fastq(native, bdggg, tmp_path):
    """BAM input through the native batch reader must classify identically
    to the same reads ingested as FASTQ (the reference recommends BAM
    input for throughput, docs/configuration.md:20)."""
    import json
    import subprocess
    import sys

    from pheniqs_tpu.io.fastq import read_fastq
    from pheniqs_tpu.io.hts import BamWriter
    from pheniqs_tpu.io.sam import AuxTags
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    # convert the three BDGGG segment files into three BAMs
    for s in (1, 2, 3):
        records = list(read_fastq(f"{bdggg}/BDGGG_s0{s}.fastq", 33))
        with open(tmp_path / f"BDGGG_s0{s}.bam", "wb") as stream:
            writer = BamWriter(stream, "@HD\tVN:1.0\n")
            for record in records:
                seq = np.frombuffer(record.sequence, dtype=np.uint8)
                writer.write_record(
                    record.name.decode(),
                    0x4 | (0x200 if record.qcfail else 0),
                    ASCII_TO_BAM[seq],
                    np.frombuffer(record.quality, dtype=np.uint8),
                    len(seq),
                    AuxTags(),
                )
            writer.close()

    import os as os_mod

    env = dict(os_mod.environ)
    env["PYTHONPATH"] = os_mod.path.dirname(
        os_mod.path.dirname(os_mod.path.abspath(__file__))
    )
    env["JAX_PLATFORMS"] = "cpu"

    outputs = {}
    for kind, base in (("fastq", bdggg), ("bam", str(tmp_path))):
        config = {
            "input": [
                f"{base}/BDGGG_s0{s}.{'fastq' if kind == 'fastq' else 'bam'}"
                for s in (1, 2, 3)
            ],
            "output": [str(tmp_path / f"out_{kind}.sam")],
            "template": {"transform": {"token": ["0::", "1::", "2::"]}},
            "sample": {
                "algorithm": "pamld",
                "confidence threshold": 0.95,
                "noise": 0.05,
                "transform": {"token": ["1::8"]},
                "codec": {
                    "@AGGCATG": {"barcode": ["AGGCATGT"]},
                    "@CACGATC": {"barcode": ["CACGATCC"]},
                    "@TCGCTAG": {"barcode": ["TCGCTAGA"]},
                },
            },
        }
        config_path = tmp_path / f"job_{kind}.json"
        config_path.write_text(json.dumps(config))
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", str(config_path), "--precision", "15"],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert result.returncode == 0, (kind, result.stderr[-2000:])
        outputs[kind] = [
            line
            for line in (tmp_path / f"out_{kind}.sam").read_text().splitlines()
            if not line.startswith("@")
        ]
    assert outputs["fastq"] == outputs["bam"]
    assert len(outputs["bam"]) > 0


def test_apply_token_block_parity(native):
    """Native Rule.apply block (pq_apply_token) == the numpy fast path,
    including short reads (tail zeroing) and strided sources."""
    import pheniqs_tpu.native as native_mod
    from pheniqs_tpu.transform import Rule, SegmentBatch

    rng = np.random.default_rng(7)
    n = 997
    arena = rng.integers(0, 16, size=(n, 64), dtype=np.uint8)
    qarena = rng.integers(0, 60, size=(n, 64), dtype=np.uint8)
    lengths = rng.integers(0, 33, size=n).astype(np.int32)
    # strided views, as the parse arena produces
    segments = [
        SegmentBatch(
            code=arena[:, 2:34], quality=qarena[:, 2:34], length=lengths
        )
    ]
    rule = Rule.from_ontology({"token": ["0:4:12", "0::8", "0:1:"]})
    a = rule.apply(segments)
    original_load = native_mod.load
    native_mod.load = lambda: None
    try:
        b = rule.apply(segments)
    finally:
        native_mod.load = original_load
    for sa, sb in zip(a, b):
        assert (sa.code == sb.code).all()
        assert (sa.quality == sb.quality).all()
        assert (sa.length == sb.length).all()


def test_observation_spans_parity(native):
    """Native fused span rendering == the numpy _observation_spans fast
    path for raw and corrected outputs, incl. undetermined rows and short
    reads."""
    from types import SimpleNamespace

    from pheniqs_tpu.engine.strict import StrictEngine
    from pheniqs_tpu.transform import SegmentBatch

    rng = np.random.default_rng(11)
    n = 511
    obs = [
        SegmentBatch(
            code=rng.integers(1, 16, size=(n, 8), dtype=np.uint8),
            quality=rng.integers(2, 42, size=(n, 8), dtype=np.uint8),
            length=np.full(n, 8, dtype=np.int32),
        ),
        SegmentBatch(
            code=rng.integers(1, 16, size=(n, 6), dtype=np.uint8),
            quality=rng.integers(2, 42, size=(n, 6), dtype=np.uint8),
            length=np.full(n, 6, dtype=np.int32),
        ),
    ]
    panel = SimpleNamespace(
        codes=rng.integers(1, 16, size=(5, 14), dtype=np.uint8),
        segment_lengths=[8, 6],
    )
    panel.segment_slices = lambda: [slice(0, 8), slice(8, 14)]
    spec = SimpleNamespace(panel=panel, corrected_quality=37)
    decoded = rng.integers(0, 6, size=n).astype(np.int32)
    result = SimpleNamespace(observation=obs, decoded=decoded)

    engine = SimpleNamespace(_native_render=True)
    a = StrictEngine._observation_spans(engine, result, spec, corrected=True)
    engine_np = SimpleNamespace(_native_render=False)
    b = StrictEngine._observation_spans(engine_np, result, spec, corrected=True)
    for key in b:
        buf_a, starts_a, lens_a = a[key]
        buf_b, starts_b, lens_b = b[key]
        assert (starts_a == starts_b).all() and (lens_a == lens_b).all()
        raw_a = bytes(buf_a)
        raw_b = buf_b if isinstance(buf_b, bytes) else bytes(buf_b)
        for i in range(n):
            assert (
                raw_a[starts_a[i] : starts_a[i] + lens_a[i]]
                == raw_b[starts_b[i] : starts_b[i] + lens_b[i]]
            ), (key, i)

    # single-segment short reads exercise min(length, width) raw lens
    obs_short = [
        SegmentBatch(
            code=obs[0].code,
            quality=obs[0].quality,
            length=rng.integers(0, 9, size=n).astype(np.int32),
        )
    ]
    panel1 = SimpleNamespace(
        codes=panel.codes[:, :8], segment_lengths=[8]
    )
    panel1.segment_slices = lambda: [slice(0, 8)]
    spec1 = SimpleNamespace(panel=panel1, corrected_quality=37)
    result1 = SimpleNamespace(observation=obs_short, decoded=decoded)
    a = StrictEngine._observation_spans(engine, result1, spec1, corrected=True)
    b = StrictEngine._observation_spans(engine_np, result1, spec1, corrected=True)
    for key in b:
        buf_a, starts_a, lens_a = a[key]
        buf_b, starts_b, lens_b = b[key]
        assert (lens_a == lens_b).all()
        raw_a = bytes(buf_a)
        raw_b = buf_b if isinstance(buf_b, bytes) else bytes(buf_b)
        for i in range(n):
            assert (
                raw_a[starts_a[i] : starts_a[i] + lens_a[i]]
                == raw_b[starts_b[i] : starts_b[i] + lens_b[i]]
            ), (key, i)


def test_emit_g_float_tags_match_python(native):
    """The to_chars '%g' path in pq_sam_format_full is byte-identical to
    Python's '%g' formatting of float32 confidences (the XB/XM/XC golden
    contract)."""
    from pheniqs_tpu.native import FloatColumn, sam_format_full

    rng = np.random.default_rng(3)
    n = 4096
    values = rng.random(n, dtype=np.float32)
    values[0] = np.float32(1e-7)  # exponent form
    values[1] = np.float32(0.1)
    values[2] = np.float32(1 - 1e-7)
    mask = (values > 0) & (values < 1)
    names = b"".join(b"r%04d" % i for i in range(n))
    offsets = np.arange(n + 1, dtype=np.int64) * 5
    code = np.ones((n, 4), dtype=np.uint8)
    quality = np.full((n, 4), 30, dtype=np.uint8)
    length = np.full(n, 4, dtype=np.int32)
    flags = np.zeros(n, dtype=np.int32)
    arena, line_offsets = sam_format_full(
        names, offsets, flags, code, quality, length, 33,
        [FloatColumn(b"XB:f:", values, mask)],
    )
    text = bytes(arena).decode()
    for i, line in enumerate(text.rstrip("\n").split("\n")):
        fields = line.split("\t")
        tag = [f for f in fields if f.startswith("XB:f:")]
        assert len(tag) == 1
        assert tag[0][5:] == "%g" % values[i], (i, tag[0], values[i])


def test_zero_copy_arena_and_dry_pool_fallback(native, bdggg):
    """Batches parsed straight into SlotArena slots (zero-copy staging)
    and batches that fall back to private memory when the pool runs dry
    (try_acquire -> None) must carry identical content."""
    from pheniqs_tpu.engine import shm
    from pheniqs_tpu.io.ingest import native_read_batches

    if not shm.shm_supported():
        pytest.skip("/dev/shm unavailable")

    urls = [f"{bdggg}/BDGGG_s0{i}.fastq" for i in (1, 2, 3)]
    plain = list(native_read_batches(urls, 33, batch_size=64))

    pool = shm.SlotPool(2)
    calls = {"n": 0}

    def provider(estimate):
        # odd calls simulate a dry pool: the ingest layer must fall back
        # to the default allocator for that batch and keep going
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            return None
        acquired = pool.try_acquire(estimate)
        if acquired is None:
            return None
        return shm.SlotArena(pool, *acquired)

    mixed = list(
        native_read_batches(urls, 33, batch_size=64, arena_provider=provider)
    )
    assert calls["n"] >= 2
    arena_batches = [
        b for b in mixed if getattr(b, "_arena", None) is not None
    ]
    assert arena_batches, "no batch took the zero-copy arena path"
    assert len(arena_batches) < len(mixed), "no batch took the fallback"
    assert len(mixed) == len(plain)
    for a, b in zip(plain, mixed):
        assert a.size == b.size
        assert a.names == b.names
        assert (a.qcfail == b.qcfail).all()
        for sa, sb in zip(a.segments, b.segments):
            n = sa.width
            assert (sa.length == sb.length).all()
            assert (sa.code[:, :n] == sb.code[:, :n]).all()
            assert (sa.quality[:, :n] == sb.quality[:, :n]).all()
    for b in mixed:
        arena = getattr(b, "_arena", None)
        if arena is not None:
            arena.release()
    pool.close()


def test_stage_batch_arena_strided_round_trip(native, bdggg):
    """An arena-parsed batch staged via stage_batch (which records
    in-slot (offset, strides) 5-tuples instead of copying) must rebuild
    byte-identical through the worker-side shm_to_batch path."""
    from pheniqs_tpu.engine import shm
    from pheniqs_tpu.io.ingest import native_read_batches

    if not shm.shm_supported():
        pytest.skip("/dev/shm unavailable")

    urls = [f"{bdggg}/BDGGG_s0{i}.fastq" for i in (1, 2, 3)]
    plain = list(native_read_batches(urls, 33, batch_size=64))

    pool = shm.SlotPool(8)

    def provider(estimate):
        acquired = pool.try_acquire(estimate)
        if acquired is None:
            return None
        return shm.SlotArena(pool, *acquired)

    rebuilt = []
    slots = []
    for batch in native_read_batches(
        urls, 33, batch_size=64, arena_provider=provider
    ):
        assert getattr(batch, "_arena", None) is not None
        batch.raw_index = len(rebuilt)
        descriptor, slot = shm.batch_to_shm(batch, None, pool, None)
        # the arena path must record strided in-slot views (5-tuples)
        # for the big matrices, not stage-time copies
        assert any(len(entry) == 5 for entry in descriptor["layout"]), (
            descriptor["layout"]
        )
        rebuilt.append(shm.shm_to_batch(descriptor)[0])
        slots.append(slot)

    assert len(rebuilt) == len(plain) and len(plain) > 1
    for a, b in zip(plain, rebuilt):
        assert a.size == b.size
        assert a.names == b.names
        assert (a.qcfail == b.qcfail).all()
        for sa, sb in zip(a.segments, b.segments):
            n = sa.width
            assert (sa.length == sb.length).all()
            assert (sa.code[:, :n] == sb.code[:, :n]).all()
            assert (sa.quality[:, :n] == sb.quality[:, :n]).all()
    for slot in slots:
        pool.release(slot)
    pool.close()


def test_slot_pool_try_acquire_dry():
    from pheniqs_tpu.engine import shm

    if not shm.shm_supported():
        pytest.skip("/dev/shm unavailable")
    pool = shm.SlotPool(1)
    first = pool.try_acquire(1024)
    assert first is not None
    assert pool.try_acquire(1024) is None  # dry, must not block
    pool.release(first[0])
    assert pool.try_acquire(1024) is not None
    pool.close()


def test_template_whole_segment_alias_semantics():
    """Rule.apply: an output slot built from ONE whole-segment token
    aliases its input arrays (zero copy — the round-5 render lever);
    slots combining tokens or slicing still copy, and values match a
    reference gather either way."""
    from pheniqs_tpu.transform import Rule, SegmentBatch

    rng = np.random.default_rng(11)
    n = 257
    code0 = rng.integers(0, 16, size=(n, 40), dtype=np.uint8)
    qual0 = rng.integers(0, 60, size=(n, 40), dtype=np.uint8)
    len0 = rng.integers(5, 41, size=n).astype(np.int32)
    code1 = rng.integers(0, 16, size=(n, 30), dtype=np.uint8)
    qual1 = rng.integers(0, 60, size=(n, 30), dtype=np.uint8)
    len1 = np.full(n, 30, dtype=np.int32)
    segments = [
        SegmentBatch(code=code0, quality=qual0, length=len0),
        SegmentBatch(code=code1, quality=qual1, length=len1),
    ]
    rule = Rule.from_ontology(
        {"token": ["0::", "1:2:10", "1:12:20"], "knit": ["0", "1:2"]}
    )
    out = rule.apply(segments)
    # slot 0: single whole-segment token -> aliased, not copied
    assert out[0].code is code0 and out[0].quality is qual0
    assert (out[0].length == len0).all()
    # slot 1: two sliced tokens -> a fresh buffer with the gathers
    assert out[1].code is not code1
    assert (out[1].code[:, :8] == code1[:, 2:10]).all()
    assert (out[1].code[:, 8:16] == code1[:, 12:20]).all()
    assert (out[1].length == 16).all()
    # a sliced single token must NOT alias (width differs)
    sliced = Rule.from_ontology({"token": ["0:1:"]})
    assert sliced.apply(segments)[0].code is not code0
