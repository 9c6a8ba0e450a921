"""Device (JAX f32) decode path vs the float64 NumPy oracle.

Verifies that the matrix-product reformulation of the PAMLD likelihood and the
device MDD decoder reproduce the oracle's classification decisions, and
that the shard_map'd multi-chip step (8 virtual CPU devices) produces the
same outputs and psum-merged counters as the single-device step.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pheniqs_tpu.decode.oracle import mdd_classify, pamld_classify
from pheniqs_tpu.decode.spec import spec_from_ontology
from pheniqs_tpu.device import compile_instrument
from pheniqs_tpu.device.classify import (
    apply_plans,
    mdd_classify_device,
    pamld_classify_device,
)
from pheniqs_tpu.device.step import make_decode_step, make_sharded_decode_step, pad_batch
from pheniqs_tpu.iupac import encode_ascii
from pheniqs_tpu.transform import SegmentBatch

BASES = "ACGT"


def random_panel(rng, barcodes, length):
    seen = set()
    out = []
    while len(out) < barcodes:
        word = "".join(rng.choice(list(BASES), size=length))
        if word not in seen:
            seen.add(word)
            out.append(word)
    return out


def make_pamld_ontology(panel, noise=0.05, confidence=0.95, segments=1):
    width = len(panel[0]) // segments
    codec = {}
    for i, word in enumerate(panel):
        codec[str(i + 1)] = {
            "barcode": [word[s * width : (s + 1) * width] for s in range(segments)],
            "concentration": (1.0 - noise) / len(panel),
            "index": i + 1,
        }
    return {
        "algorithm": "pamld",
        "index": 1,
        "codec": codec,
        "noise": noise,
        "confidence threshold": confidence,
        "random barcode probability": 1.0 / (4 ** len(panel[0])),
        "high quality threshold": 30,
        "high quality distance threshold": 0,
        "transform": {
            "token": [f"0:{s * width}:{(s + 1) * width}" for s in range(segments)]
        },
    }


def simulate_reads(rng, panel, n, error_rate=0.05):
    width = len(panel[0])
    code = np.zeros((n, width), dtype=np.uint8)
    qual = np.zeros((n, width), dtype=np.uint8)
    for i in range(n):
        word = panel[rng.integers(len(panel))]
        arr = encode_ascii(word).copy()
        q = rng.integers(8, 41, size=width)
        err = rng.random(width) < error_rate
        for p in np.flatnonzero(err):
            arr[p] = encode_ascii(rng.choice(list(BASES)))[0]
            q[p] = rng.integers(2, 25)
        code[i] = arr
        qual[i] = q
    length = np.full(n, width, dtype=np.int32)
    return code, qual, length


@pytest.fixture(scope="module")
def pamld_case():
    rng = np.random.default_rng(7)
    panel = random_panel(rng, 24, 12)
    ontology = make_pamld_ontology(panel)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(rng, panel, 512)
    return spec, ontology, code, qual, length


def test_pamld_device_matches_oracle(pamld_case):
    spec, ontology, code, qual, length = pamld_case
    n = code.shape[0]
    qcfail = np.zeros(n, dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)

    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1})
    dec = instrument.decoders[0]
    device = pamld_classify_device(
        instrument,
        dec,
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    decoded = np.asarray(device["decoded"])
    np.testing.assert_array_equal(decoded, oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)
    np.testing.assert_array_equal(np.asarray(device["branch"]), oracle.branch)
    np.testing.assert_array_equal(np.asarray(device["distance"]), oracle.edit_distance)
    np.testing.assert_allclose(
        np.asarray(device["confidence"]), oracle.confidence, rtol=2e-4, atol=1e-6
    )


def test_pamld_device_short_observation(pamld_case):
    """Reads shorter than the barcode: trailing positions are (code 0, q 0)
    and contribute nothing to sigma_q, mirroring the NUL-terminator rule."""
    spec, ontology, code, qual, length = pamld_case
    code = code.copy()
    qual = qual.copy()
    code[:, -2:] = 0
    qual[:, -2:] = 0
    qcfail = np.zeros(code.shape[0], dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)
    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1})
    device = pamld_classify_device(
        instrument,
        instrument.decoders[0],
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)


def make_mdd_ontology(panel, tolerance, segments=1, qmt=0):
    ontology = make_pamld_ontology(panel, segments=segments)
    ontology["algorithm"] = "mdd"
    ontology["distance tolerance"] = [tolerance] * segments
    if qmt:
        ontology["quality masking threshold"] = qmt
    return ontology


@pytest.mark.parametrize("qmt", [0, 12])
def test_mdd_device_matches_oracle(qmt):
    rng = np.random.default_rng(11)
    panel = random_panel(rng, 16, 10)
    ontology = make_mdd_ontology(panel, tolerance=2, segments=2, qmt=qmt)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(rng, panel, 512, error_rate=0.12)
    n = code.shape[0]
    qcfail = np.zeros(n, dtype=bool)

    half = len(panel[0]) // 2
    obs = [
        SegmentBatch(
            code=code[:, :half], quality=qual[:, :half],
            length=np.full(n, half, dtype=np.int32),
        ),
        SegmentBatch(
            code=code[:, half:], quality=qual[:, half:],
            length=np.full(n, half, dtype=np.int32),
        ),
    ]
    oracle = mdd_classify(spec, obs, qcfail)

    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1})
    dec = instrument.decoders[0]
    observation = [
        (
            jnp.asarray(s.code.astype(np.int32)),
            jnp.asarray(s.quality.astype(np.int32)),
            jnp.asarray(s.length),
        )
        for s in obs
    ]
    device = mdd_classify_device(dec, observation, jnp.asarray(qcfail))
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["distance"]), oracle.edit_distance)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)


def test_apply_plans_matches_host_rule(pamld_case):
    spec, ontology, code, qual, length = pamld_case
    n = code.shape[0]
    batch_seg = SegmentBatch(code=code, quality=qual, length=length)
    host_obs = spec.rule.apply([batch_seg])

    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1})
    dec = instrument.decoders[0]
    device_obs = apply_plans(
        dec,
        [
            (
                jnp.asarray(code.astype(np.int32)),
                jnp.asarray(qual.astype(np.int32)),
                jnp.asarray(length),
            )
        ],
    )
    for host, (dc, dq, dl) in zip(host_obs, device_obs):
        np.testing.assert_array_equal(host.code, np.asarray(dc).astype(np.uint8))
        np.testing.assert_array_equal(host.quality, np.asarray(dq).astype(np.uint8))
        np.testing.assert_array_equal(host.length, np.asarray(dl))


def test_sharded_step_matches_single_device(pamld_case):
    spec, ontology, code, qual, length = pamld_case
    n = code.shape[0]
    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1})
    batch = {
        "segments": [
            (
                jnp.asarray(code.astype(np.int32)),
                jnp.asarray(qual.astype(np.int32)),
                jnp.asarray(length),
            )
        ],
        "qcfail": jnp.zeros(n, dtype=bool),
    }

    single = jax.jit(make_decode_step(instrument))
    per_read_1, counters_1 = single(batch)

    devices = jax.devices()
    assert len(devices) >= 8, "conftest must force an 8-device CPU mesh"
    mesh = Mesh(np.array(devices[:8]), ("reads",))
    sharded = make_sharded_decode_step(instrument, mesh)
    padded, true_n = pad_batch(batch, 8)
    per_read_8, counters_8 = sharded(padded)

    np.testing.assert_array_equal(
        np.asarray(per_read_8["decoders"][0]["decoded"])[:true_n],
        np.asarray(per_read_1["decoders"][0]["decoded"]),
    )
    np.testing.assert_array_equal(
        np.asarray(per_read_8["channel_index"])[:true_n],
        np.asarray(per_read_1["channel_index"]),
    )
    # psum-merged counters == single-device counters + padding rows
    pad_rows = padded["qcfail"].shape[0] - true_n
    c1 = np.asarray(counters_1[0]["count"])
    c8 = np.asarray(counters_8[0]["count"])
    assert c8[0] == c1[0] + pad_rows  # padding decodes to unclassified
    np.testing.assert_allclose(c8[1:], c1[1:])
    np.testing.assert_allclose(
        np.asarray(counters_8[0]["accumulated_confidence"]),
        np.asarray(counters_1[0]["accumulated_confidence"]),
        rtol=1e-5,
    )


def test_large_panel_chunked_posterior_matches_oracle():
    """Panels beyond LARGE_PANEL_B stream through the online-logsumexp scan
    without materializing (N, B); decisions must still match the oracle."""
    rng = np.random.default_rng(23)
    panel = random_panel(rng, 1500, 12)
    ontology = make_pamld_ontology(panel)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(rng, panel, 256)
    qcfail = np.zeros(256, dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)

    instrument = compile_instrument(
        {"sample": ontology, "input segment cardinality": 1}
    )
    from pheniqs_tpu.device.classify import LARGE_PANEL_B

    assert instrument.decoders[0].barcode_count > LARGE_PANEL_B
    device = pamld_classify_device(
        instrument,
        instrument.decoders[0],
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)
    np.testing.assert_allclose(
        np.asarray(device["confidence"]), oracle.confidence, rtol=1e-3, atol=1e-6
    )


def test_ambiguous_panel_codes_match_oracle():
    """Panels containing IUPAC ambiguity codes (N, R, Y...) take the
    UNIFORM likelihood branch; device decisions must match the oracle."""
    rng = np.random.default_rng(41)
    panel = ["ACGTNNACGT", "TGCARYTGCA", "GGTTCCAAGG", "NNNNNNNNNN"]
    ontology = make_pamld_ontology(panel)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(
        rng, ["ACGTAAACGT", "TGCAAGTGCA", "GGTTCCAAGG", "CATGCATGCA"], 512
    )
    # sprinkle observed N bases as well
    n_mask = rng.random(code.shape) < 0.05
    code = np.where(n_mask, np.uint8(15), code)
    qcfail = np.zeros(code.shape[0], dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)

    instrument = compile_instrument(
        {"sample": ontology, "input segment cardinality": 1}
    )
    device = pamld_classify_device(
        instrument,
        instrument.decoders[0],
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)
    np.testing.assert_array_equal(
        np.asarray(device["distance"]), oracle.edit_distance
    )


def test_high_quality_distance_filter_matches_oracle():
    """hqd filter active (threshold 1, like BDGGG): device qcfail must
    match the oracle exactly on error-heavy reads."""
    rng = np.random.default_rng(53)
    panel = random_panel(rng, 12, 10)
    ontology = make_pamld_ontology(panel, noise=0.02, confidence=0.9)
    ontology["high quality distance threshold"] = 1
    ontology["high quality threshold"] = 20
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(rng, panel, 1024, error_rate=0.15)
    qcfail = np.zeros(code.shape[0], dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)

    instrument = compile_instrument(
        {"sample": ontology, "input segment cardinality": 1}
    )
    device = pamld_classify_device(
        instrument,
        instrument.decoders[0],
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)


def test_distance_paths_identical(monkeypatch):
    """The decoded-barcode distance has two integer-exact algorithms —
    the one-hot match contraction and the row gather
    (instrument._distance_by_gather) — selected at trace time. Both must
    produce identical distances and hq-filter decisions (the default
    backends otherwise never cover the contraction path)."""
    rng = np.random.default_rng(61)
    panel = random_panel(rng, 12, 10)
    ontology = make_pamld_ontology(panel, noise=0.02, confidence=0.9)
    ontology["high quality distance threshold"] = 1
    ontology["high quality threshold"] = 20
    code, qual, length = simulate_reads(rng, panel, 1024, error_rate=0.15)
    qcfail = np.zeros(code.shape[0], dtype=bool)
    instrument = compile_instrument(
        {"sample": ontology, "input segment cardinality": 1}
    )

    outputs = {}
    for path in ("contraction", "gather"):
        monkeypatch.setenv("PHENIQS_DISTANCE_PATH", path)
        outputs[path] = pamld_classify_device(
            instrument,
            instrument.decoders[0],
            jnp.asarray(code.astype(np.int32)),
            jnp.asarray(qual.astype(np.int32)),
            jnp.asarray(qcfail),
        )
    for key in ("decoded", "distance", "qcfail", "branch", "argmax"):
        np.testing.assert_array_equal(
            np.asarray(outputs["contraction"][key]),
            np.asarray(outputs["gather"][key]),
            err_msg=key,
        )


@pytest.mark.parametrize(
    "backend, forced, expected",
    [
        ("gpu", None, True),  # measured: the gather wins on the H100
        ("cpu", None, True),
        ("gpu", "contraction", False),
        ("cpu", "contraction", False),
        ("gpu", "gather", True),
    ],
)
def test_distance_path_choice(monkeypatch, backend, forced, expected):
    """The default distance algorithm is the one measured faster on each
    backend (instrument._distance_by_gather cites the numbers);
    PHENIQS_DISTANCE_PATH overrides it on any backend."""
    from pheniqs_tpu.device.instrument import _distance_by_gather

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if forced is None:
        monkeypatch.delenv("PHENIQS_DISTANCE_PATH", raising=False)
    else:
        monkeypatch.setenv("PHENIQS_DISTANCE_PATH", forced)
    assert _distance_by_gather() is expected


def test_distance_path_rejects_unknown(monkeypatch):
    from pheniqs_tpu.device.instrument import _distance_by_gather
    from pheniqs_tpu.errors import ConfigurationError

    monkeypatch.setenv("PHENIQS_DISTANCE_PATH", "scatter")
    with pytest.raises(ConfigurationError):
        _distance_by_gather()


def test_100k_barcode_panel_smoke():
    """The SURVEY-scale regime: a 100k-barcode 16nt panel classifies
    through the chunked online-logsumexp path and matches the f64 oracle's
    decisions (the reference's serial scan would visit all 100k barcodes
    per read; here it is 98 scanned chunks)."""
    rng = np.random.default_rng(99)
    panel = random_panel(rng, 100000, 16)
    ontology = make_pamld_ontology(panel)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, length = simulate_reads(rng, panel, 48)
    qcfail = np.zeros(48, dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)

    instrument = compile_instrument(
        {"sample": ontology, "input segment cardinality": 1}
    )
    device = pamld_classify_device(
        instrument,
        instrument.decoders[0],
        jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail),
    )
    np.testing.assert_array_equal(np.asarray(device["decoded"]), oracle.decoded)
    np.testing.assert_array_equal(np.asarray(device["qcfail"]), oracle.qcfail)


def test_h2d_blob_round_trip():
    """The packed host->device wire format must survive pack -> device
    unpack exactly (codes, qualities, lengths, qcfail)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pheniqs_tpu.device.step import (
        _unpack_h2d_blob,
        h2d_blob_bytes,
        pack_h2d_blob,
    )

    rng = np.random.default_rng(21)
    n = 257
    widths = [8, 16]
    segments = []
    for w in widths:
        code = rng.integers(0, 16, size=(n, w)).astype(np.uint8)
        qual = rng.integers(0, 64, size=(n, w)).astype(np.uint8)
        length = rng.integers(0, w + 1, size=n).astype(np.int32)
        segments.append((code, qual, length))
    qcfail = (rng.random(n) < 0.3).astype(np.uint8)

    blob = pack_h2d_blob(widths, segments, qcfail)
    assert blob.shape == (n, h2d_blob_bytes(widths))

    unpacked, fail, pad, forced = jax.jit(
        lambda b: _unpack_h2d_blob(widths, b)
    )(jnp.asarray(blob))
    for (code, qual, length), (u_code, u_qual, u_length) in zip(
        segments, unpacked
    ):
        np.testing.assert_array_equal(np.asarray(u_code), code)
        np.testing.assert_array_equal(np.asarray(u_qual), qual)
        np.testing.assert_array_equal(np.asarray(u_length), length)
    np.testing.assert_array_equal(np.asarray(fail), qcfail.astype(bool))
    assert not np.asarray(pad).any()
    assert not np.asarray(forced).any()


def test_h2d_native_pack_matches_numpy():
    """The native (C++, GIL-released) packer must be byte-identical to the
    numpy reference path across ragged widths, clamped qualities and
    out-of-range lengths."""
    import numpy as np
    import pytest

    from pheniqs_tpu.native import available, pack_h2d_native
    from pheniqs_tpu.device.step import h2d_blob_bytes, pack_h2d_blob

    if not available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(77)
    n = 1023
    widths = [8, 12, 28]       # bucket widths (multiples of 4)
    source_widths = [8, 10, 26]  # actual segment widths (sw <= w)
    segments = []
    for w, sw in zip(widths, source_widths):
        code = rng.integers(0, 16, size=(n, sw)).astype(np.uint8)
        qual = rng.integers(0, 80, size=(n, sw)).astype(np.uint8)  # some >63
        length = rng.integers(-2, sw + 3, size=n).astype(np.int32)
        segments.append((code, qual, length))
    qcfail = (rng.random(n) < 0.25).astype(np.uint8)

    import os

    os.environ["PHENIQS_NATIVE_PACK"] = "0"
    try:
        reference = pack_h2d_blob(widths, segments, qcfail)
    finally:
        os.environ.pop("PHENIQS_NATIVE_PACK")
    native = np.zeros((n, h2d_blob_bytes(widths)), dtype=np.uint8)
    assert pack_h2d_native(widths, segments, qcfail, native)
    np.testing.assert_array_equal(native, reference)


def test_h2d_blob_quality_clamp_flags_forced():
    """Qualities >= 64 clamp to 63 on the wire and flag the row H2D_FORCED
    so the hybrid engine re-resolves it with the exact float64 oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pheniqs_tpu.device.step import _unpack_h2d_blob, pack_h2d_blob

    n, w = 16, 8
    code = np.full((n, w), 1, dtype=np.uint8)
    qual = np.full((n, w), 40, dtype=np.uint8)
    qual[3, 2] = 70  # beyond the 6-bit wire range
    qual[9, 0] = 93
    length = np.full(n, w, dtype=np.int32)
    qcfail = np.zeros(n, dtype=np.uint8)

    blob = pack_h2d_blob([w], [(code, qual, length)], qcfail)
    unpacked, fail, pad, forced = jax.jit(
        lambda b: _unpack_h2d_blob([w], b)
    )(jnp.asarray(blob))
    u_code, u_qual, _ = unpacked[0]
    np.testing.assert_array_equal(np.asarray(u_code), code)
    np.testing.assert_array_equal(
        np.asarray(u_qual), np.minimum(qual, 63)
    )
    expected_forced = np.zeros(n, dtype=bool)
    expected_forced[[3, 9]] = True
    np.testing.assert_array_equal(np.asarray(forced), expected_forced)
    assert not np.asarray(fail).any()
    assert not np.asarray(pad).any()


def test_h2d_codebook_wire_round_trip():
    """Wire v3: 2-bit and 4-bit quality codebooks survive pack -> device
    unpack exactly for in-codebook values, and out-of-codebook values
    within the read's length flag H2D_FORCED (beyond-length padding never
    does)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pheniqs_tpu.device.step import (
        _unpack_h2d_blob,
        h2d_blob_bytes,
        pack_h2d_blob,
        sense_qual_codebook,
    )

    rng = np.random.default_rng(33)
    for alphabet, expect_bits in (
        ((2, 12, 23, 37), 2),
        (tuple(range(2, 2 + 13)), 4),
    ):
        qual_bits, qcb, lut_idx, lut_exact = sense_qual_codebook(
            np.array(alphabet)
        )
        assert qual_bits == expect_bits
        n, w = 129, 16
        code = rng.integers(0, 16, size=(n, w)).astype(np.uint8)
        qual = rng.choice(np.array(alphabet, dtype=np.uint8), size=(n, w))
        length = rng.integers(0, w + 1, size=n).astype(np.int32)
        # row 5: out-of-codebook value inside the read -> forced;
        # row 7: out-of-codebook value beyond the length -> NOT forced
        length[5] = w
        qual[5, 3] = 41
        length[7] = 4
        qual[7, 10] = 41
        qcfail = (rng.random(n) < 0.3).astype(np.uint8)

        blob = pack_h2d_blob(
            [w], [(code, qual, length)], qcfail,
            qual_bits=qual_bits, qual_lut=(lut_idx, lut_exact),
        )
        assert blob.shape == (n, h2d_blob_bytes([w], qual_bits))
        unpacked, fail, pad, forced = jax.jit(
            lambda b, cb: _unpack_h2d_blob([w], b, qual_bits=qual_bits, qcb=cb)
        )(jnp.asarray(blob), jnp.asarray(qcb))
        u_code, u_qual, u_length = unpacked[0]
        np.testing.assert_array_equal(np.asarray(u_code), code)
        np.testing.assert_array_equal(np.asarray(u_length), length)
        expected_qual = np.asarray(qcb)[lut_idx[qual]]
        np.testing.assert_array_equal(np.asarray(u_qual), expected_qual)
        # every in-codebook position decodes to its exact value
        exact = lut_exact[qual].astype(bool)
        np.testing.assert_array_equal(
            np.asarray(u_qual)[exact], qual.astype(np.int32)[exact]
        )
        expected_forced = np.zeros(n, dtype=bool)
        expected_forced[5] = True
        np.testing.assert_array_equal(np.asarray(forced), expected_forced)
        np.testing.assert_array_equal(np.asarray(fail), qcfail.astype(bool))


def test_h2d_codebook_native_pack_matches_numpy():
    """The native codebook packer (wire v3) must be byte-identical to the
    numpy path across ragged widths and out-of-codebook values."""
    import os

    import numpy as np
    import pytest

    from pheniqs_tpu.device.step import (
        h2d_blob_bytes,
        pack_h2d_blob,
        sense_qual_codebook,
    )
    from pheniqs_tpu.native import available, pack_h2d_native

    if not available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(55)
    n = 511
    for alphabet in ((2, 12, 23, 37), tuple(range(30, 42))):
        qual_bits, qcb, lut_idx, lut_exact = sense_qual_codebook(
            np.array(alphabet)
        )
        widths = [8, 12, 28]
        source_widths = [8, 10, 26]
        segments = []
        for w, sw in zip(widths, source_widths):
            code = rng.integers(0, 16, size=(n, sw)).astype(np.uint8)
            qual = rng.choice(
                np.array(alphabet, dtype=np.uint8), size=(n, sw)
            )
            stray = rng.random((n, sw)) < 0.01  # out-of-codebook sprinkle
            qual[stray] = 63
            length = rng.integers(-2, sw + 3, size=n).astype(np.int32)
            segments.append((code, qual, length))
        qcfail = (rng.random(n) < 0.25).astype(np.uint8)

        os.environ["PHENIQS_NATIVE_PACK"] = "0"
        try:
            reference = pack_h2d_blob(
                widths, segments, qcfail,
                qual_bits=qual_bits, qual_lut=(lut_idx, lut_exact),
            )
        finally:
            os.environ.pop("PHENIQS_NATIVE_PACK")
        native = np.zeros(
            (n, h2d_blob_bytes(widths, qual_bits)), dtype=np.uint8
        )
        assert pack_h2d_native(
            widths, segments, qcfail, native,
            qual_bits=qual_bits, qual_lut=(lut_idx, lut_exact),
        )
        np.testing.assert_array_equal(native, reference)


def test_h2d_joint_wire_round_trip():
    """Wire j4: the joint (base, quality) pair codebook survives pack ->
    device unpack exactly for in-codebook pairs; out-of-codebook pairs
    within the read's length flag H2D_FORCED (beyond-length padding never
    does)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pheniqs_tpu.device.step import (
        JOINT4,
        _unpack_h2d_blob,
        h2d_blob_bytes,
        pack_h2d_blob,
        sense_joint_codebook,
    )

    rng = np.random.default_rng(41)
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    quals = np.array([2, 12, 23, 37], dtype=np.uint8)
    pairs = [
        int(c) * 256 + int(q) for c in codes for q in quals
    ]  # 16 pairs: exactly fills the codebook
    ccb, qcb, lut_idx, lut_exact = sense_joint_codebook(pairs)
    assert lut_exact.sum() == 16

    n, w = 193, 16
    code = rng.choice(codes, size=(n, w))
    qual = rng.choice(quals, size=(n, w))
    length = rng.integers(0, w + 1, size=n).astype(np.int32)
    # row 4: out-of-codebook pair (N base) inside the read -> forced;
    # row 6: out-of-codebook pair beyond the length -> NOT forced
    length[4] = w
    code[4, 5] = 15  # N
    qual[4, 5] = 2
    length[6] = 3
    code[6, 9] = 15
    qcfail = (rng.random(n) < 0.3).astype(np.uint8)

    blob = pack_h2d_blob(
        [w], [(code, qual, length)], qcfail,
        qual_bits=JOINT4, qual_lut=(lut_idx, lut_exact),
    )
    assert blob.shape == (n, h2d_blob_bytes([w], JOINT4))
    assert h2d_blob_bytes([w], JOINT4) == w // 2 + 1 + 1

    unpacked, fail, pad, forced = jax.jit(
        lambda b, cc, qc: _unpack_h2d_blob(
            [w], b, qual_bits=JOINT4, qcb=qc, ccb=cc
        )
    )(jnp.asarray(blob), jnp.asarray(ccb), jnp.asarray(qcb))
    u_code, u_qual, u_length = unpacked[0]
    np.testing.assert_array_equal(np.asarray(u_length), length)
    key = code.astype(np.int64) * 256 + qual
    exact = lut_exact[key].astype(bool)
    np.testing.assert_array_equal(
        np.asarray(u_code)[exact], code.astype(np.int32)[exact]
    )
    np.testing.assert_array_equal(
        np.asarray(u_qual)[exact], qual.astype(np.int32)[exact]
    )
    # the nearest-pair policy keeps the quality for an unknown base pair
    np.testing.assert_array_equal(
        np.asarray(u_qual)[4, 5], 2
    )
    expected_forced = np.zeros(n, dtype=bool)
    expected_forced[4] = True
    np.testing.assert_array_equal(np.asarray(forced), expected_forced)
    np.testing.assert_array_equal(np.asarray(fail), qcfail.astype(bool))


def test_h2d_joint_native_pack_matches_numpy():
    """The native joint packer (wire j4) must be byte-identical to the
    numpy path across ragged widths and out-of-codebook pairs."""
    import os

    import numpy as np
    import pytest

    from pheniqs_tpu.device.step import (
        JOINT4,
        h2d_blob_bytes,
        pack_h2d_blob,
        sense_joint_codebook,
    )
    from pheniqs_tpu.native import available, pack_h2d_native

    if not available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(59)
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    quals = np.array([2, 12, 23, 37], dtype=np.uint8)
    pairs = [int(c) * 256 + int(q) for c in codes for q in quals]
    ccb, qcb, lut_idx, lut_exact = sense_joint_codebook(pairs)

    n = 511
    widths = [8, 12, 28]
    source_widths = [8, 10, 26]
    segments = []
    for w, sw in zip(widths, source_widths):
        code = rng.choice(codes, size=(n, sw))
        qual = rng.choice(quals, size=(n, sw))
        stray = rng.random((n, sw)) < 0.01
        code[stray] = 15  # N sprinkle: out-of-codebook pairs
        length = rng.integers(-2, sw + 3, size=n).astype(np.int32)
        segments.append((code, qual, length))
    qcfail = (rng.random(n) < 0.25).astype(np.uint8)

    os.environ["PHENIQS_NATIVE_PACK"] = "0"
    try:
        reference = pack_h2d_blob(
            widths, segments, qcfail,
            qual_bits=JOINT4, qual_lut=(lut_idx, lut_exact),
        )
    finally:
        os.environ.pop("PHENIQS_NATIVE_PACK")
    native = np.zeros(
        (n, h2d_blob_bytes(widths, JOINT4)), dtype=np.uint8
    )
    assert pack_h2d_native(
        widths, segments, qcfail, native,
        qual_bits=JOINT4, qual_lut=(lut_idx, lut_exact),
    )
    np.testing.assert_array_equal(native, reference)


def test_sense_joint_codebook_regimes():
    """<=16 distinct pairs -> joint codebook; more -> None (fall back to
    the quality-lane codebooks)."""
    from pheniqs_tpu.device.step import sense_joint_codebook

    pairs = [c * 256 + q for c in (1, 2, 4, 8) for q in (2, 12, 23)]
    result = sense_joint_codebook(pairs)
    assert result is not None
    ccb, qcb, lut_idx, lut_exact = result
    assert len(ccb) == len(qcb) == 16
    assert lut_exact.sum() == 12
    # NovaSeq with N no-calls: 13 pairs, still joint
    pairs.append(15 * 256 + 2)
    assert sense_joint_codebook(pairs) is not None
    # 17 pairs: too rich
    pairs17 = [c * 256 + q for c in (1, 2, 4, 8) for q in (2, 12, 23, 37)]
    pairs17.append(15 * 256 + 2)
    assert sense_joint_codebook(pairs17) is None
    assert sense_joint_codebook([]) is None


def test_sense_qual_codebook_regimes():
    """Alphabet size selects the wire: <=4 values -> 2-bit, <=16 -> 4-bit,
    larger -> the lossless 6-bit layout; explicit modes override."""
    from pheniqs_tpu.device.step import sense_qual_codebook

    bits, qcb, _, _ = sense_qual_codebook([2, 12, 23, 37])
    assert bits == 2 and list(qcb) == [2, 12, 23, 37]
    bits, qcb, _, _ = sense_qual_codebook([2, 12, 23])
    assert bits == 2 and list(qcb) == [2, 12, 23, 23]  # padded
    bits, qcb, _, _ = sense_qual_codebook(list(range(10, 20)))
    assert bits == 4 and len(qcb) == 16
    bits, qcb, _, _ = sense_qual_codebook(list(range(0, 40)))
    assert bits == 6 and qcb is None
    bits, _, _, _ = sense_qual_codebook([2, 12, 23, 37], mode="6")
    assert bits == 6
    bits, qcb, _, _ = sense_qual_codebook([2, 12], mode="4")
    assert bits == 4 and len(qcb) == 16
    # values above 63 clamp into the 6-bit domain before sensing
    bits, qcb, _, _ = sense_qual_codebook([2, 70])
    assert bits == 2 and list(qcb)[:2] == [2, 63]


def test_static_window_token_path_matches_general_gather():
    """The forward fixed-token fast path (two static slices + row select)
    must equal the general clipped gather for every length regime: longer
    than the token, inside it, shorter than the token start, and zero."""
    from pheniqs_tpu.device.instrument import TokenPlan, DeviceDecoder
    from pheniqs_tpu.device.classify import apply_plans

    rng = np.random.default_rng(17)
    n, w_in = 64, 24
    code = rng.integers(1, 16, size=(n, w_in)).astype(np.int32)
    qual = rng.integers(1, 42, size=(n, w_in)).astype(np.int32)
    # lengths exercising every branch: 0, < start, == start, inside
    # the token, beyond it, and the full segment width
    length = np.array(
        [0, 1, 3, 5, 6, 7, 9, 11, 12, 13, 17, 24] * 6, dtype=np.int32
    )[:n]

    def run(plan):
        dec = DeviceDecoder(
            algorithm="pamld", classifier_type="sample", index=0,
            multiplexing=True, plans=[plan],
            segment_widths=[plan.width],
        )
        return apply_plans(
            dec,
            [(jnp.asarray(code), jnp.asarray(qual), jnp.asarray(length))],
        )

    for start, end in [(5, 12), (0, 8), (3, 24), (20, 30)]:
        width = end - start
        fast = run(TokenPlan(0, start, end, True, False, 0, width))
        # the general path, forced by a negative-start twin resolving to
        # the same coordinates for every row with length == w_in is NOT
        # equivalent in general — so compare against a NumPy oracle of
        # the clipped-gather semantics instead
        s = np.where(start > length, 0, start)
        e = np.minimum(end, length)
        size = np.maximum(e - s, 0)
        offsets = np.arange(width)[None, :]
        gather = np.clip(s[:, None] + offsets, 0, w_in - 1)
        valid = offsets < size[:, None]
        want_code = np.where(valid, np.take_along_axis(code, gather, 1), 0)
        want_qual = np.where(valid, np.take_along_axis(qual, gather, 1), 0)
        got_code, got_qual, got_len = fast[0]
        np.testing.assert_array_equal(np.asarray(got_code), want_code)
        np.testing.assert_array_equal(np.asarray(got_qual), want_qual)
        np.testing.assert_array_equal(np.asarray(got_len), size)


def test_analytic_tpq_epsilon_is_tiny():
    """The transcendental-free TPQ must sit within ~1 ulp-scale of the f64
    table on EVERY backend — a regression here silently degrades hybrid
    mode to strict-engine throughput by flagging every read (a backend
    log1p once measured 3.3e-4 relative did exactly that). The
    formulation is pure mul/add/select, so the bound should hold
    bit-identically everywhere."""
    from pheniqs_tpu.device.instrument import analytic_tpq_epsilon

    assert analytic_tpq_epsilon() < 2e-6
