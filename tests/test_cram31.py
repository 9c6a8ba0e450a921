"""CRAM 3.1 read/write: rANS Nx16 + tok3 name tokenizer. Conformance vectors are hand-derived from the hts-specs
CRAMcodecs document (htslib is absent from this environment, as for the
3.0 core-codec vectors); the e2e case pins a 3.1 container against its
SAM-level truth through the real writer/reader pair."""

import io
import os

import numpy as np
import pytest

from pheniqs_tpu.errors import IOError_
from pheniqs_tpu.io.rans_nx16 import (
    CAT,
    NOSZ,
    ORDER1,
    PACK,
    RLE,
    STRIPE,
    X32,
    rans_nx16_compress,
    rans_nx16_uncompress,
    uint7_get,
    uint7_put,
)
from pheniqs_tpu.io.tok3 import tok3_decode, tok3_encode

# --- hand-derived conformance vectors --------------------------------------


def test_uint7_vectors():
    # big-endian 7-bit groups, high bit = continuation
    assert uint7_put(0) == b"\x00"
    assert uint7_put(127) == b"\x7f"
    assert uint7_put(128) == b"\x81\x00"
    assert uint7_put(2731) == bytes((0x80 | 21, 43))  # 2731 = 21*128+43
    for v in (0, 1, 127, 128, 300, 2731, 1 << 20):
        got, off = uint7_get(uint7_put(v), 0)
        assert got == v and off == len(uint7_put(v))


def test_order0_hand_vector():
    """data b'aab', N=4: normalized freqs a=2731 b=1365 (scale-to-4096
    with the remainder on the most frequent), alphabet RLE 61 62 00 00,
    states computed by hand through the rANS advance
    x' = (x//f)<<12 + x%f + c from L=0x8000."""
    stream = bytes(
        [
            0x00,                      # flags: order-0, 4-way
            0x03,                      # ulen = 3
            0x61, 0x62, 0x00, 0x00,    # alphabet {a, b}
            0x95, 0x2B,                # F[a] = 2731
            0x8A, 0x55,                # F[b] = 1365
            0xA7, 0xBA, 0x00, 0x00,    # state0 = 47783 ('a')
            0xA7, 0xBA, 0x00, 0x00,    # state1 = 47783 ('a')
            0xB3, 0x8A, 0x01, 0x00,    # state2 = 101043 ('b')
            0x00, 0x80, 0x00, 0x00,    # state3 = L (unused)
        ]
    )
    assert rans_nx16_uncompress(stream) == b"aab"
    assert rans_nx16_compress(b"aab", 0) == stream


def test_pack_cat_hand_vector():
    # 'ACCA' bit-packs over the 2-symbol map {A, C} LSB-first: 0b0110
    stream = bytes([CAT | PACK, 4, 2, 0x41, 0x43, 1, 0b0110])
    assert rans_nx16_uncompress(stream) == b"ACCA"


def test_rle_cat_hand_vector():
    # 'aaaab': symbol 'a' carries runs; meta = [n=1, 'a', run=3] stored
    # raw (odd length field), literals 'ab' stored CAT
    stream = bytes([CAT | RLE, 5, 2, (3 << 1) | 1, 1, 0x61, 3, 0x61, 0x62])
    assert rans_nx16_uncompress(stream) == b"aaaab"


# --- property round-trips --------------------------------------------------

FLAG_MATRIX = [
    0, ORDER1, X32, ORDER1 | X32, PACK, RLE, PACK | RLE, CAT, STRIPE,
    STRIPE | ORDER1, NOSZ, ORDER1 | PACK | RLE, X32 | PACK,
]


def _payloads():
    rng = np.random.default_rng(42)
    return {
        "empty": b"",
        "single": b"Q",
        "uniform": bytes(rng.integers(0, 256, 4000, dtype=np.uint8)),
        "rta3-quals": bytes(
            rng.choice([2, 12, 23, 37], p=[0.02, 0.1, 0.3, 0.58], size=30000)
            .astype(np.uint8)
        ),
        "runs": b"".join(
            bytes([c]) * int(r)
            for c, r in zip(
                rng.integers(60, 70, 800), rng.integers(1, 40, 800)
            )
        ),
        "binary-pair": bytes(
            rng.choice([0, 255], size=5001).astype(np.uint8)
        ),
    }


@pytest.mark.parametrize("flags", FLAG_MATRIX, ids=lambda f: hex(f))
def test_rans_nx16_round_trip(flags):
    for name, data in _payloads().items():
        comp = rans_nx16_compress(data, flags)
        out = rans_nx16_uncompress(
            comp, expected_size=len(data) if flags & NOSZ else None
        )
        assert out == data, (name, hex(flags))


def test_rans_nx16_truncation_fails_typed():
    data = _payloads()["rta3-quals"]
    for flags in (0, ORDER1, PACK | RLE, STRIPE):
        comp = rans_nx16_compress(data, flags)
        for cut in (1, 2, 5, len(comp) // 2, len(comp) - 1):
            try:
                out = rans_nx16_uncompress(comp[:cut])
                # a lucky prefix may decode; it must not round-trip
                assert out != data
            except IOError_:
                pass


def test_rans_nx16_bitflip_fails_typed_or_differs():
    data = _payloads()["runs"]
    comp = bytearray(rans_nx16_compress(data, ORDER1))
    rng = np.random.default_rng(9)
    for _ in range(40):
        pos = int(rng.integers(0, len(comp)))
        orig = comp[pos]
        comp[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            rans_nx16_uncompress(bytes(comp))
        except IOError_:
            pass
        comp[pos] = orig


# --- tok3 ------------------------------------------------------------------


def test_tok3_round_trip_illumina_names():
    rng = np.random.default_rng(1)
    names = [
        (
            f"A00534:24:H7LT2DSXX:1:{1101 + int(rng.integers(0, 4))}"
            f":{int(rng.integers(1000, 32000))}"
            f":{int(rng.integers(1000, 32000))}"
        ).encode()
        for _ in range(4000)
    ]
    names += names[:7]  # whole-name duplicates
    names += [b"weird 0071", b"", b"x" * 500, b"a1b02c003"]
    blob = tok3_encode(names)
    assert tok3_decode(blob) == names
    raw = sum(len(n) + 1 for n in names)
    assert len(blob) < raw / 3  # it actually tokenizes, not stores


def test_tok3_zero_padded_and_overflow_digits():
    names = [b"0", b"00", b"007", b"4294967295", b"4294967296", b"99999999999"]
    assert tok3_decode(tok3_encode(names)) == names


def test_tok3_truncation_fails_typed():
    blob = tok3_encode([b"abc:1:2", b"abc:1:3", b"abc:2:9"])
    for cut in range(0, len(blob), 3):
        try:
            tok3_decode(blob[:cut])
        except IOError_:
            pass


def test_tok3_arith_flag_gated():
    blob = bytearray(tok3_encode([b"n1", b"n2"]))
    blob[8] |= 1  # claim arithmetic-coded streams
    with pytest.raises(IOError_):
        tok3_decode(bytes(blob))


# --- CRAM 3.1 container e2e ------------------------------------------------

HEADER = "@HD\tVN:1.6\tSO:unsorted\n@RG\tID:rg1\tSM:s\n"


def _write_31(tmp_path, n=6000, version=(3, 1)):
    from pheniqs_tpu.io.cram import CramWriter
    from pheniqs_tpu.io.sam import AuxTags
    from pheniqs_tpu.iupac import ASCII_TO_BAM

    rng = np.random.default_rng(3)
    truth = []
    buf = io.BytesIO()
    writer = CramWriter(buf, HEADER, version=version)
    for i in range(n):
        name = f"A00534:24:H7LT2DSXX:1:{1101 + i % 4}:{1000 + i}:{2000 + i}"
        ln = int(rng.integers(20, 80))
        seq = "".join(
            "ACGTN"[b]
            for b in rng.choice(5, p=[0.24, 0.24, 0.24, 0.24, 0.04], size=ln)
        )
        qual = rng.choice(
            [2, 12, 23, 37], p=[0.02, 0.1, 0.3, 0.58], size=ln
        ).astype(np.uint8)
        code = ASCII_TO_BAM[np.frombuffer(seq.encode(), dtype=np.uint8)]
        writer.write_record(name, 4, code, qual, ln, AuxTags())
        truth.append((name.encode(), seq.encode(), qual.tobytes()))
    writer.close()
    path = tmp_path / "t31.cram"
    path.write_bytes(buf.getvalue())
    return path, truth, buf.getvalue()


def test_cram31_container_round_trip(tmp_path):
    from pheniqs_tpu.io.cram import RANS_NX16, TOK3, read_cram
    from pheniqs_tpu.iupac import BAM_TO_ASCII

    path, truth, blob = _write_31(tmp_path)
    assert blob[4:6] == bytes((3, 1))
    # the container actually uses the 3.1 codecs (method bytes present
    # in block headers — weak scan, pinned properly by the decode)
    assert any(b == RANS_NX16 for b in blob) and any(b == TOK3 for b in blob)
    count = 0
    for record in read_cram(str(path)):
        name, seq, qual = truth[count]
        assert record.name == name
        assert BAM_TO_ASCII[record.code].tobytes() == seq
        assert record.quality.tobytes() == qual
        count += 1
    assert count == len(truth)


def test_cram31_smaller_than_30(tmp_path):
    _, _, blob31 = _write_31(tmp_path, n=4000, version=(3, 1))
    _, _, blob30 = _write_31(tmp_path, n=4000, version=(3, 0))
    assert len(blob31) < len(blob30)


def test_cram31_batch_reader_path(tmp_path):
    """The demux batch intake (NativeCramReader python path) reads 3.1
    containers too."""
    from pheniqs_tpu.io.cram import NativeCramReader

    path, truth, _ = _write_31(tmp_path, n=3000)
    reader = NativeCramReader(str(path))
    total = 0
    while True:
        batch = reader.read_batch(1024)
        if batch is None:
            break
        code, qual, length, qcfail, names_blob, offsets = batch
        size = length.shape[0]
        for k in range(size):
            name = names_blob[offsets[k] : offsets[k + 1]]
            assert name == truth[total + k][0], (total + k, name)
        total += size
    assert total == len(truth)


def test_cram31_arith_method_fails_typed(tmp_path):
    """A block claiming the (ungated) adaptive arithmetic codec fails
    typed, not with a crash."""
    import struct
    import zlib

    from pheniqs_tpu.io.cram import ARITH, read_block

    body = (
        bytes((ARITH, 4))
        + b"\x00"            # content id
        + b"\x03"            # compressed size
        + b"\x05"            # raw size
        + b"abc"
    )
    block = body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    with pytest.raises(IOError_):
        read_block(block, 0)


def test_cram_version_write_gate():
    from pheniqs_tpu.io.cram import CramWriter

    with pytest.raises(IOError_):
        CramWriter(io.BytesIO(), HEADER, version=(4, 0))


def test_native_nx16_parity_with_python():
    """The native C++ Nx16 coder must emit byte-identical streams to the
    pure-Python encoder (both are production writers depending on build
    availability) and each must decode the other's output."""
    from pheniqs_tpu import native
    from pheniqs_tpu.io import rans_nx16 as R

    if native.load() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    payloads = [
        bytes(rng.choice([2, 12, 23, 37], p=[0.02, 0.1, 0.3, 0.58],
                         size=100000).astype(np.uint8)),
        bytes(rng.integers(0, 256, 65536, dtype=np.uint8)),
        bytes(rng.integers(0, 4, 300, dtype=np.uint8)),
    ]
    for data in payloads:
        for flags in (0, ORDER1, X32, ORDER1 | X32):
            native_bytes = native.rans_nx16_compress(data, flags)
            assert native_bytes is not None
            real_load = native.load
            native.load = lambda: None
            try:
                python_bytes = R.rans_nx16_compress(data, flags)
                python_of_native = R._uncompress(native_bytes)
            finally:
                native.load = real_load
            assert native_bytes == python_bytes, hex(flags)
            assert python_of_native == data
            assert native.rans_nx16_uncompress(python_bytes, len(data)) == data


def test_cram31_cli_streamed_output(tmp_path):
    """`PHENIQS_CRAM_VERSION=3.1` through the real CLI at --threads 3:
    worker-built slice parts carry the 3.1 codecs and the reader gets
    every record back."""
    import json
    import subprocess
    import sys

    reference_root = "/root/reference"
    if not os.path.isdir(reference_root):
        pytest.skip("reference repository not mounted")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["PHENIQS_CRAM_VERSION"] = "3.1"
    out = tmp_path / "bdggg31.cram"
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
         "--config", "test/BDGGG/BDGGG_annotated.json",
         "--precision", "15", "--threads", "3",
         "--output", str(out), "--report", "/dev/null"],
        cwd=reference_root, env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    blob = out.read_bytes()
    assert blob[4:6] == bytes((3, 1))
    from pheniqs_tpu.io.cram import read_cram

    records = list(read_cram(str(out)))
    assert len(records) == 496  # 248 pf reads x 2 output segments
    # serial run content-identical (names + sequences in order)
    env2 = dict(env)
    out2 = tmp_path / "serial31.cram"
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
         "--config", "test/BDGGG/BDGGG_annotated.json",
         "--precision", "15", "--threads", "1",
         "--output", str(out2), "--report", "/dev/null"],
        cwd=reference_root, env=env2, capture_output=True, text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    serial = list(read_cram(str(out2)))
    assert [(r.name, r.code.tobytes()) for r in records] == [
        (r.name, r.code.tobytes()) for r in serial
    ]


# --- round-5 self-review regression pins ------------------------------------


def _alphabet_overrun_stream() -> bytes:
    """Alphabet: symbol 250 then run byte 200 — a naive parser walks the
    symbol value to 451 and indexes 256-entry tables out of bounds."""
    from pheniqs_tpu.io.rans_nx16 import uint7_put

    body = bytes([250, 251, 200])  # 250, then 251 (=250+1) with run 200
    # terminator + fake freqs + states
    body += bytes([0]) + b"\x10" * 260 + b"\x00\x80\x00\x00" * 4
    return bytes([0x00]) + uint7_put(300) + body


@pytest.mark.parametrize("native_path", [False, True])
def test_alphabet_overrun_fails_typed(native_path, monkeypatch):
    """A crafted RLE alphabet walking past symbol 255 must fail typed on
    BOTH decoders (the native one used to write out of bounds)."""
    from pheniqs_tpu import native

    if native_path and native.load() is None:
        pytest.skip("native library unavailable")
    if not native_path:
        monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(IOError_):
        rans_nx16_uncompress(_alphabet_overrun_stream())


def test_stripe_nosz_round_trip():
    data = bytes(np.random.default_rng(8).integers(0, 200, 4097,
                                                   dtype=np.uint8))
    comp = rans_nx16_compress(data, STRIPE | NOSZ)
    assert rans_nx16_uncompress(comp, expected_size=len(data)) == data


def test_tok3_high_position_duplicate_streams():
    """Names with >255 token positions whose type-stream bodies repeat
    at high positions: the single-byte dup reference cannot express
    pos > 255, so those streams must serialize directly (used to raise
    ValueError in the encoder)."""
    piece = b"".join(b"%d." % (i % 10) for i in range(130))
    names = [piece + b"A" * 10 + b"%d" % i for i in range(5)]
    assert tok3_decode(tok3_encode(names)) == names


def test_o1_table_length_cap_fails_typed():
    """A crafted order-1 stream demanding a multi-GB table allocation
    fails typed instead of raising MemoryError / looping forever."""
    from pheniqs_tpu.io.rans_nx16 import uint7_put

    stream = (
        bytes([ORDER1]) + uint7_put(300)       # plausible output size
        + bytes([(12 << 4) | 1])               # compressed tables
        + uint7_put(10) + uint7_put(1 << 40)   # clen=10, tlen=1TB
        + b"\x00" * 64
    )
    with pytest.raises(IOError_):
        rans_nx16_uncompress(stream)


def test_cram31_to_bam_transcode(tmp_path):
    """The CRAM->BAM transcode tool path reads 3.1 containers (Nx16 +
    tok3) through the same vectorized slice decoder as 3.0."""
    from pheniqs_tpu.io.cram import cram_to_bam
    from pheniqs_tpu.io.hts import read_bam

    path, truth, _ = _write_31(tmp_path, n=2000)
    bam = tmp_path / "t31.bam"
    cram_to_bam(str(path), str(bam))
    records = list(read_bam(str(bam)))
    assert len(records) == len(truth)
    assert records[0].name == truth[0][0]
    assert records[-1].quality.tobytes() == truth[-1][2]


def test_tok3_dzlen_overflow_names():
    """Zero-padded digit runs wider than the one-byte DZLEN field store
    verbatim instead of crashing the encoder (FASTQ names are unbounded;
    only BAM caps QNAME length)."""
    names = [b"0" * 255 + b"7", b"0" * 300 + b"1", b"x" + b"0" * 256]
    assert tok3_decode(tok3_encode(names)) == names


def test_rans_nx16_declared_size_mismatch_fails_fast():
    """A sized stream whose declared length disagrees with the container
    fails typed BEFORE allocating what the stream claims."""
    comp = rans_nx16_compress(b"payload-bytes" * 40, ORDER1)
    with pytest.raises(IOError_):
        rans_nx16_uncompress(comp, expected_size=13)
