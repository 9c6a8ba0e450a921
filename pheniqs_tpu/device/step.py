"""The decode step: one jitted XLA program per instruction, and its
multi-chip SPMD wrapper.

``make_decode_step`` builds a pure function (batch) -> (per_read, counters)
covering every classifier of the instruction in the reference classify
order (sample, molecular*, cellular*; reference transcode.h:51-65), the
channel-routing index, and the statistics counters that feed the JSON
report. Counters are one-hot contractions, so they emerge as small (B+1,)
vectors per decoder.

``make_sharded_decode_step`` wraps the step in ``shard_map`` over a 1-D
``reads`` mesh axis — the device analog of the reference's N identical
decoding threads over shared feeds (reference transcode.cpp:1491-1500):
read batches are sharded over cards, the barcode panels and LUTs are
replicated, and the per-decoder counters are merged with one ``psum``
exactly where the reference merges thread-local accumulators at collect
time (reference transcode.cpp:317-320).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .classify import (
    BRANCH_LOW_CONFIDENCE,
    BRANCH_NOISE,
    BRANCH_PASS,
    apply_plans,
    mdd_classify_device,
    pamld_classify_device,
)
from .instrument import DeviceDecoder, DeviceInstrument


def _segment_sum(index: jnp.ndarray, weights: jnp.ndarray, b1: int) -> jnp.ndarray:
    """Stacked per-barcode sums: (N,) index + (N, K) weights -> (b1, K) via
    one one-hot contraction (single pass over the batch)."""
    onehot = jax.nn.one_hot(index, b1, dtype=jnp.float32)  # (N, b1)
    return jnp.einsum(
        "nb,nk->bk", onehot, weights, precision=jax.lax.Precision.HIGHEST
    )


def _counters(dec: DeviceDecoder, result: dict, valid=None) -> dict:
    """Per-batch accumulator deltas (reference selector.h:32-92), fused into
    one stacked one-hot contraction over the (B+1) barcode axis (row 0 =
    unclassified), plus one for the argmax-keyed filter counters.

    ``valid`` (optional (N,) f32 0/1) excludes rows from every counter —
    the engine masks padding rows and hybrid-uncertain rows, recording the
    latter host-side from the float64 oracle instead."""
    b1 = dec.barcode_count + 1
    decoded = result["decoded"]
    branch = result["branch"]
    pf = (~result["qcfail"]).astype(jnp.float32)
    ones = jnp.ones_like(pf)

    columns = [ones, pf]
    names = ["count", "pf_count"]
    if dec.algorithm in ("pamld", "mdd"):
        distance = result["distance"].astype(jnp.float32)
        dist_mask = ((decoded > 0) & (result["distance"] > 0)).astype(jnp.float32)
        columns += [distance * dist_mask, distance * dist_mask * pf]
        names += ["accumulated_distance", "accumulated_pf_distance"]
    if dec.algorithm == "pamld":
        passed = (branch == BRANCH_PASS).astype(jnp.float32)
        confidence = result["confidence"]
        columns += [confidence * passed, confidence * passed * pf]
        names += ["accumulated_confidence", "accumulated_pf_confidence"]

    weights = jnp.stack(columns, axis=1)
    if valid is not None:
        weights = weights * valid[:, None]
    stacked = _segment_sum(decoded, weights, b1)
    counters = {name: stacked[:, k] for k, name in enumerate(names)}

    if dec.algorithm == "pamld":
        filter_weights = jnp.stack(
            [
                (branch == BRANCH_LOW_CONFIDENCE).astype(jnp.float32),
                (branch == BRANCH_NOISE).astype(jnp.float32),
            ],
            axis=1,
        )
        if valid is not None:
            filter_weights = filter_weights * valid[:, None]
        filters = _segment_sum(result["argmax"], filter_weights, b1)
        counters["low_confidence_count"] = filters[:, 0]
        counters["low_conditional_confidence_count"] = filters[:, 1]
    return counters


def _classify_one(
    instrument: DeviceInstrument,
    dec: DeviceDecoder,
    segments,
    qcfail,
    want_uncertain: bool = False,
    panel_shard=None,
    panel_axis: str | None = None,
):
    n = qcfail.shape[0]
    if dec.algorithm == "passthrough" or not dec.plans:
        return {
            "decoded": jnp.zeros(n, dtype=jnp.int32),
            "confidence": jnp.zeros(n, dtype=jnp.float32),
            "distance": jnp.zeros(n, dtype=jnp.int32),
            "qcfail": qcfail,
            "branch": jnp.zeros(n, dtype=jnp.int8),
            "argmax": jnp.zeros(n, dtype=jnp.int32),
        }
    observation = apply_plans(dec, segments)
    if dec.algorithm == "naive":
        return {
            "decoded": jnp.zeros(n, dtype=jnp.int32),
            "confidence": jnp.zeros(n, dtype=jnp.float32),
            "distance": jnp.zeros(n, dtype=jnp.int32),
            "qcfail": qcfail,
            "branch": jnp.zeros(n, dtype=jnp.int8),
            "argmax": jnp.zeros(n, dtype=jnp.int32),
        }
    if dec.algorithm == "pamld":
        obs_code = jnp.concatenate([c for c, _, _ in observation], axis=1)
        obs_qual = jnp.concatenate([q for _, q, _ in observation], axis=1)
        result = pamld_classify_device(
            instrument, dec, obs_code, obs_qual, qcfail,
            want_uncertain=want_uncertain,
            panel_shard=panel_shard,
            panel_axis=panel_axis,
        )
        if want_uncertain:
            # observations shorter than the decoder token depend on the
            # reference's serial scratch-carry semantics (reference
            # sequence.h:61-67): always oracle-resolved by the hybrid host
            short = jnp.zeros(n, dtype=bool)
            for width, (_, _, length) in zip(dec.segment_widths, observation):
                short = short | (length < width)
            result["uncertain"] = result["uncertain"] | short
        return result
    if dec.algorithm == "mdd":
        return mdd_classify_device(dec, observation, qcfail)
    raise ValueError(f"unknown algorithm {dec.algorithm}")


# --- host<->device wire format v2 ------------------------------------------
#
# Every wire byte crosses the host link, and the decode itself is cheap
# next to the host pipeline — so the wire format is kept dense (the role
# the reference's feed ring buffers play for its CPU pipeline, reference
# transcode.cpp:1776-1795). Host->device packs each
# base to 10 bits: the BAM nucleotide code is 4 bits by construction
# (reference iupac.h:27-50) and Illumina qualities are <= 41 < 64, so a
# 6-bit quality is lossless in practice; rows carrying any quality >= 64
# are flagged (H2D_FORCED) and the hybrid engine re-resolves them with the
# exact float64 oracle, keeping strict-identity guarantees intact.
# Layout per read:  per segment [w/2 B nibble-packed codes][3w/4 B 6-bit
# packed qualities][1-2 B length], then one flags byte.
#
# Wire v3 (quality codebook): modern Illumina basecallers emit a handful
# of distinct quality values (NovaSeq RTA3 bins to exactly {2,12,23,37}),
# so the engine senses the quality alphabet from the first batch and —
# when it fits — sends 2-bit (<=4 values) or 4-bit (<=16) CODEBOOK INDICES
# instead of 6-bit values. The codebook itself is a tiny runtime argument
# (`qcb`, (K,) int32) so the compiled program (and its AOT-store key) is
# independent of the actual quality values. Any later row carrying a
# quality outside the codebook is packed as the nearest entry and flagged
# H2D_FORCED — the same oracle re-resolution contract as the >=64 clamp —
# so hybrid strict-identity is preserved verbatim in every regime.

H2D_QCFAIL = 1  #: flags bit 0: read arrived qc-failed
H2D_PAD = 2     #: flags bit 1: padding row — excluded from counters
H2D_FORCED = 4  #: flags bit 2: lossy quality on the wire; force oracle re-resolve


def _length_bytes(w: int) -> int:
    return 1 if w < 256 else 2


#: joint wire mode: one 4-bit lane of (base, quality) PAIR codebook
#: indices replaces both the code and quality lanes (modern binned
#: basecallers emit <=16 distinct pairs: {A,C,G,T} x 3-4 quality bins
#: plus (N, q2), so the whole base fits in 4 bits)
JOINT4 = "j4"


def _lane_bytes(w: int, qual_bits) -> tuple[int, int]:
    """(code_lane, quality_lane) wire bytes of one segment (w a multiple
    of 4). Joint mode fuses both lanes into one 4-bit index lane."""
    if qual_bits == JOINT4:
        return 0, w // 2
    return w // 2, {2: w // 4, 4: w // 2, 6: (3 * w) // 4}[qual_bits]


def _qual_bytes(w: int, qual_bits) -> int:
    return _lane_bytes(w, qual_bits)[1]


def h2d_blob_bytes(widths: list[int], qual_bits=6) -> int:
    """Bytes per read of the packed host->device layout for `widths`
    (each a multiple of 4, as the engine's width buckets guarantee)."""
    return (
        sum(
            sum(_lane_bytes(w, qual_bits)) + _length_bytes(w)
            for w in widths
        )
        + 1
    )


def sense_qual_codebook(values, mode: str = "auto"):
    """Choose the quality wire regime from the distinct quality values of a
    (representative) batch.

    Returns ``(qual_bits, codebook, lut_idx, lut_exact)`` — codebook is the
    (K,) int32 runtime argument for the device unpack (K = 4 or 16, padded
    by repeating the last entry), lut_idx maps any byte value to its
    nearest codebook index, and lut_exact marks the byte values the
    codebook represents losslessly (everything else gets H2D_FORCED).
    For ``qual_bits == 6`` (codebook doesn't fit, or mode forces it) the
    codebook/luts are None and the classic 10-bit layout applies.
    """
    import numpy as np

    values = np.unique(np.minimum(np.asarray(values, dtype=np.int64), 63))
    if mode == "6":
        return 6, None, None, None
    if mode == "2" or (mode == "auto" and values.size <= 4):
        k = 4
    elif mode == "4" or (mode == "auto" and values.size <= 16):
        k = 16
    else:
        return 6, None, None, None
    if values.size > k or values.size == 0:
        return 6, None, None, None
    codebook = np.empty(k, dtype=np.int32)
    codebook[: values.size] = values
    codebook[values.size :] = values[-1]
    domain = np.minimum(np.arange(256, dtype=np.int64), 63)
    # nearest codebook entry per byte value (distance in quality space:
    # only flagged rows can be affected, and those re-resolve in f64)
    dist = np.abs(domain[:, None] - values[None, :])
    lut_idx = np.argmin(dist, axis=1).astype(np.uint8)
    lut_exact = np.zeros(256, dtype=np.uint8)
    exact = np.isin(np.arange(256, dtype=np.int64), values)
    lut_exact[exact] = 1
    return (2 if k == 4 else 4), codebook, lut_idx, lut_exact


def sense_joint_codebook(pairs):
    """Joint (code, quality) pair codebook for the `j4` wire: ``pairs`` is
    the distinct ``code * 256 + min(quality, 63)`` keys of a representative
    batch. Returns ``(ccb, qcb, lut_idx, lut_exact)`` — ccb/qcb are the
    (16,) int32 code/quality runtime arguments (padded by repeating the
    last pair), lut_idx maps any 12-bit ``(code & 15) << 8 | quality`` key
    to its nearest codebook index, lut_exact marks the exactly-represented
    keys — or ``None`` when the alphabet doesn't fit in 16 pairs.
    """
    import numpy as np

    pairs = np.unique(np.asarray(pairs, dtype=np.int64))
    if pairs.size == 0 or pairs.size > 16:
        return None
    codes = pairs >> 8
    quals = np.minimum(pairs & 255, 63)
    if (codes > 15).any():
        return None
    ccb = np.empty(16, dtype=np.int32)
    qcb = np.empty(16, dtype=np.int32)
    ccb[: pairs.size] = codes
    ccb[pairs.size :] = codes[-1]
    qcb[: pairs.size] = quals
    qcb[pairs.size :] = quals[-1]
    domain_code = np.arange(4096, dtype=np.int64) >> 8
    domain_qual = np.minimum(np.arange(4096, dtype=np.int64) & 255, 63)
    # nearest entry: same code strongly preferred (a wrong quality only
    # shifts the likelihood; a wrong base flips it), then quality distance
    # — only H2D_FORCED rows can be affected, and those re-resolve in f64
    dist = (domain_code[:, None] != codes[None, :]) * 1000 + np.abs(
        domain_qual[:, None] - quals[None, :]
    )
    lut_idx = np.argmin(dist, axis=1).astype(np.uint8)
    lut_exact = np.zeros(4096, dtype=np.uint8)
    lut_exact[codes * 256 + quals] = 1
    return ccb, qcb, lut_idx, lut_exact


def pack_h2d_blob(
    widths: list[int],
    segments,
    qcfail,
    out=None,
    qual_bits: int = 6,
    qual_lut=None,
):
    """Host-side packing of per-segment (code, qual, length) + flags into
    one (N, bytes_per_read) uint8 matrix — a single transfer per batch.

    Codes nibble-pack two per byte. Qualities: ``qual_bits == 6`` clamps
    to 63 and packs four per three bytes (rows with a quality >= 64 get
    H2D_FORCED); ``qual_bits`` 2/4 pack CODEBOOK INDICES via ``qual_lut =
    (lut_idx, lut_exact)`` from `sense_qual_codebook`, force-flagging any
    row whose quality isn't represented exactly. ``qual_bits == JOINT4``
    replaces BOTH lanes with one 4-bit (code, quality) pair-index lane
    (``qual_lut`` from `sense_joint_codebook`, same forced contract).
    """
    import numpy as np

    n = qcfail.shape[0]
    blob = out if out is not None else np.empty(
        (n, h2d_blob_bytes(widths, qual_bits)), dtype=np.uint8
    )
    if qual_bits != 6 and qual_lut is None:
        raise ValueError("qual_bits < 6 requires qual_lut")
    if os.environ.get("PHENIQS_NATIVE_PACK", "1") != "0":
        from ..native import pack_h2d_native

        # byte-identical native path (GIL released): parity pinned by
        # tests/test_device_wire.py; falls back on layout mismatch
        if pack_h2d_native(
            widths, segments, qcfail, blob, qual_bits=qual_bits,
            qual_lut=qual_lut,
        ):
            return blob
    flags = np.asarray(qcfail, dtype=np.uint8) * H2D_QCFAIL
    offset = 0
    for w, (code, qual, length) in zip(widths, segments):
        if w % 4:
            raise ValueError(f"h2d segment width {w} not a multiple of 4")
        sw = code.shape[1]
        cw, qw = _lane_bytes(w, qual_bits)
        code = np.asarray(code, dtype=np.uint8)
        qual = np.asarray(qual, dtype=np.uint8)
        if sw < w:
            code = np.concatenate(
                [code, np.zeros((n, w - sw), dtype=np.uint8)], axis=1
            )
            qual = np.concatenate(
                [qual, np.zeros((n, w - sw), dtype=np.uint8)], axis=1
            )
        if qual_bits == JOINT4:
            lut_idx, lut_exact = qual_lut
            key = (code.astype(np.int32) & 15) << 8 | qual
            inexact = lut_exact[key] == 0
            inexact &= (
                np.arange(w, dtype=np.int32)[None, :]
                < np.asarray(length, dtype=np.int32)[:, None]
            )
            if inexact.any():
                flags |= inexact.any(axis=1).astype(np.uint8) * H2D_FORCED
            idx = lut_idx[key]
            blob[:, offset : offset + qw] = idx[:, 0::2] | (idx[:, 1::2] << 4)
            offset += qw
            clipped = np.clip(length, 0, w)
            if _length_bytes(w) == 1:
                blob[:, offset] = clipped.astype(np.uint8)
                offset += 1
            else:
                blob[:, offset] = (clipped & 0xFF).astype(np.uint8)
                blob[:, offset + 1] = (clipped >> 8).astype(np.uint8)
                offset += 2
            continue
        blob[:, offset : offset + cw] = code[:, 0::2] | (code[:, 1::2] << 4)
        offset += cw
        if qual_bits == 6:
            overflow = qual > 63
            if overflow.any():
                flags |= overflow.any(axis=1).astype(np.uint8) * H2D_FORCED
                qual = np.minimum(qual, 63)
            q4 = qual.reshape(n, w // 4, 4).astype(np.uint16)
            # strided column assignment (a reshape of the blob slice may copy)
            blob[:, offset : offset + qw : 3] = (
                q4[:, :, 0] | (q4[:, :, 1] << 6)
            ).astype(np.uint8)
            blob[:, offset + 1 : offset + qw : 3] = (
                (q4[:, :, 1] >> 2) | (q4[:, :, 2] << 4)
            ).astype(np.uint8)
            blob[:, offset + 2 : offset + qw : 3] = (
                (q4[:, :, 2] >> 4) | (q4[:, :, 3] << 2)
            ).astype(np.uint8)
        else:
            lut_idx, lut_exact = qual_lut
            inexact = lut_exact[qual] == 0
            # exactness only matters within the read: positions beyond
            # `length` (buffer padding) never reach a decode decision —
            # short-vs-token reads are independently force-re-resolved
            inexact &= (
                np.arange(w, dtype=np.int32)[None, :]
                < np.asarray(length, dtype=np.int32)[:, None]
            )
            if inexact.any():
                flags |= inexact.any(axis=1).astype(np.uint8) * H2D_FORCED
            idx = lut_idx[qual]
            if qual_bits == 2:
                q4 = idx.reshape(n, w // 4, 4).astype(np.uint16)
                blob[:, offset : offset + qw] = (
                    q4[:, :, 0]
                    | (q4[:, :, 1] << 2)
                    | (q4[:, :, 2] << 4)
                    | (q4[:, :, 3] << 6)
                ).astype(np.uint8)
            else:  # 4-bit
                blob[:, offset : offset + qw] = (
                    idx[:, 0::2] | (idx[:, 1::2] << 4)
                )
        offset += qw
        clipped = np.clip(length, 0, w)
        if _length_bytes(w) == 1:
            blob[:, offset] = clipped.astype(np.uint8)
            offset += 1
        else:
            blob[:, offset] = (clipped & 0xFF).astype(np.uint8)
            blob[:, offset + 1] = (clipped >> 8).astype(np.uint8)
            offset += 2
    blob[:, offset] = flags
    return blob


def _codebook_select(idx, table):
    """Decode codebook indices to values via a K-way select chain of
    elementwise ops (no dynamic gather)."""
    table = table.astype(jnp.int32)
    value = jnp.full_like(idx, table[0])
    for k in range(1, table.shape[0]):
        value = jnp.where(idx == k, table[k], value)
    return value


def _unpack_h2d_blob(
    widths: list[int], blob, qual_bits=6, qcb=None, ccb=None
):
    """Device-side unpack (inside jit: slices + a few elementwise bit ops; the
    10-bit wire format costs a handful of elementwise ops against a ~40%
    transfer-byte reduction, and the codebook formats cut further).
    ``qcb`` is the (K,) int32 quality codebook runtime argument for
    qual_bits 2/4; JOINT4 additionally takes ``ccb`` (16,) int32 and
    decodes both lanes from the pair index.
    Returns (segments, qcfail, pad, forced)."""
    segments = []
    offset = 0
    n = blob.shape[0]
    for w in widths:
        cw, qw = _lane_bytes(w, qual_bits)
        if qual_bits == JOINT4:
            packed = blob[:, offset : offset + qw].astype(jnp.int32)
            idx = jnp.stack([packed & 15, packed >> 4], axis=2).reshape(n, w)
            code = _codebook_select(idx, ccb)
            qual = _codebook_select(idx, qcb)
            offset += qw
            if _length_bytes(w) == 1:
                length = blob[:, offset].astype(jnp.int32)
                offset += 1
            else:
                length = (
                    blob[:, offset].astype(jnp.int32)
                    | (blob[:, offset + 1].astype(jnp.int32) << 8)
                )
                offset += 2
            segments.append((code, qual, length))
            continue
        packed_c = blob[:, offset : offset + cw].astype(jnp.int32)
        code = jnp.stack([packed_c & 15, packed_c >> 4], axis=2).reshape(n, w)
        offset += cw
        if qual_bits == 6:
            q3 = blob[:, offset : offset + qw].astype(jnp.int32).reshape(
                n, w // 4, 3
            )
            qual = jnp.stack(
                [
                    q3[:, :, 0] & 63,
                    (q3[:, :, 0] >> 6) | ((q3[:, :, 1] & 15) << 2),
                    (q3[:, :, 1] >> 4) | ((q3[:, :, 2] & 3) << 4),
                    q3[:, :, 2] >> 2,
                ],
                axis=2,
            ).reshape(n, w)
        else:
            packed_q = blob[:, offset : offset + qw].astype(jnp.int32)
            if qual_bits == 2:
                idx = jnp.stack(
                    [
                        packed_q & 3,
                        (packed_q >> 2) & 3,
                        (packed_q >> 4) & 3,
                        packed_q >> 6,
                    ],
                    axis=2,
                ).reshape(n, w)
            else:  # 4-bit
                idx = jnp.stack(
                    [packed_q & 15, packed_q >> 4], axis=2
                ).reshape(n, w)
            qual = _codebook_select(idx, qcb)
        offset += qw
        if _length_bytes(w) == 1:
            length = blob[:, offset].astype(jnp.int32)
            offset += 1
        else:
            length = (
                blob[:, offset].astype(jnp.int32)
                | (blob[:, offset + 1].astype(jnp.int32) << 8)
            )
            offset += 2
        segments.append((code, qual, length))
    flags = blob[:, offset].astype(jnp.int32)
    qcfail = (flags & H2D_QCFAIL) > 0
    pad = (flags & H2D_PAD) > 0
    forced = (flags & H2D_FORCED) > 0
    return segments, qcfail, pad, forced


def counter_layout(instrument: DeviceInstrument) -> list[tuple[int, str, int]]:
    """Deterministic (decoder position, counter name, vector length) order
    of the flattened device counter vector. The flattening exists for the
    wire: a dict of ~20 small arrays costs ~20 round trips per batch on a
    high-latency link; one concatenated f32 vector costs one."""
    layout = []
    for position, dec in enumerate(instrument.decoders):
        b1 = dec.barcode_count + 1
        names = ["count", "pf_count"]
        if dec.algorithm in ("pamld", "mdd"):
            names += ["accumulated_distance", "accumulated_pf_distance"]
        if dec.algorithm == "pamld":
            names += [
                "accumulated_confidence",
                "accumulated_pf_confidence",
                "low_confidence_count",
                "low_conditional_confidence_count",
            ]
        layout.extend((position, name, b1) for name in names)
    return layout


def flatten_counters(instrument: DeviceInstrument, counters: list) -> jnp.ndarray:
    parts = []
    for position, name, _size in counter_layout(instrument):
        parts.append(counters[position][name])
    if not parts:
        return jnp.zeros(0, dtype=jnp.float32)
    return jnp.concatenate(parts)


def d2h_layout(instrument: DeviceInstrument, want_uncertain: bool) -> dict:
    """Byte layout of the packed device->host decision blob, shared by the
    device pack (make_decode_step) and the engine unpack.

    Per read: one int16 (int32 for >=32000-barcode panels) decoded index
    per pamld/mdd decoder, one f32 confidence per pamld decoder, ceil(d/8)
    bytes of per-decoder chained-qcfail bits, and (hybrid only) one
    uncertain byte. Distance/argmax/branch stay on device: they feed only
    the statistics counters, which are computed there (reference
    selector.h:32-92 via `_counters`)."""
    wide = any(dec.barcode_count >= 32000 for dec in instrument.decoders)
    index_size = 4 if wide else 2
    decoded_positions = [
        k
        for k, dec in enumerate(instrument.decoders)
        if dec.algorithm in ("pamld", "mdd")
    ]
    confidence_positions = [
        k
        for k, dec in enumerate(instrument.decoders)
        if dec.algorithm == "pamld"
    ]
    d = len(instrument.decoders)
    qcfail_bytes = -(-d // 8)
    int_bytes = index_size * len(decoded_positions)
    float_bytes = 4 * len(confidence_positions)
    return {
        "wide": wide,
        "index_size": index_size,
        "decoded_positions": decoded_positions,
        "confidence_positions": confidence_positions,
        "int_bytes": int_bytes,
        "float_offset": int_bytes,
        "float_bytes": float_bytes,
        "qcfail_offset": int_bytes + float_bytes,
        "qcfail_bytes": qcfail_bytes,
        "uncertain_offset": int_bytes + float_bytes + qcfail_bytes,
        "total": int_bytes
        + float_bytes
        + qcfail_bytes
        + (1 if want_uncertain else 0),
    }


def make_decode_step(
    instrument: DeviceInstrument,
    axis_name: str | None = None,
    want_uncertain: bool = False,
    want_counters: bool = True,
    pack_outputs: bool = False,
    h2d_widths: list[int] | None = None,
    panel_axis: str | None = None,
    qual_bits: int = 6,
):
    """Build the (batch) -> (per_read, counters) step function.

    ``batch`` is a dict: ``segments`` — list of (code (N, Wi) int32,
    quality (N, Wi) int32, length (N,) int32) — and ``qcfail`` (N,) bool.
    With ``h2d_widths`` the step instead takes {"blob": (N, bytes) uint8}
    packed by `pack_h2d_blob` (one transfer up, one back); for
    ``qual_bits`` 2/4 the batch additionally carries the quality codebook
    ``qcb`` ((K,) int32, replicated).
    When ``axis_name`` is given, counters are psum'd over that mesh axis.
    """

    def step(batch):
        pad = None
        forced = None
        if h2d_widths is not None:
            segments, qcfail, pad, forced = _unpack_h2d_blob(
                h2d_widths,
                batch["blob"],
                qual_bits=qual_bits,
                qcb=batch.get("qcb"),
                ccb=batch.get("ccb"),
            )
        else:
            segments = [
                (c.astype(jnp.int32), q.astype(jnp.int32), l.astype(jnp.int32))
                for c, q, l in batch["segments"]
            ]
            qcfail = batch["qcfail"]

        panel_shards = batch.get("panel_shards", {}) if panel_axis else {}
        per_read = []
        results = []
        for position, dec in enumerate(instrument.decoders):
            result = _classify_one(
                instrument, dec, segments, qcfail,
                want_uncertain=want_uncertain,
                panel_shard=panel_shards.get(str(position)),
                panel_axis=panel_axis,
            )
            qcfail = result["qcfail"]
            entry = {
                "decoded": result["decoded"],
                "confidence": result["confidence"],
                "distance": result["distance"],
                "branch": result["branch"],
                "argmax": result["argmax"],
                "qcfail": result["qcfail"],
            }
            if want_uncertain:
                entry["uncertain"] = result.get(
                    "uncertain", jnp.zeros(qcfail.shape[0], dtype=bool)
                )
            per_read.append(entry)
            results.append(result)

        n = qcfail.shape[0]
        # rows the host re-resolves with the exact oracle (hybrid): any
        # decoder's derived f32 bound fired, or the H2D flags forced it
        uncertain_any = jnp.zeros(n, dtype=bool)
        if want_uncertain:
            for entry in per_read:
                uncertain_any = uncertain_any | entry["uncertain"]
            if forced is not None:
                uncertain_any = uncertain_any | forced

        counters = []
        if want_counters:
            valid = None
            if pad is not None or want_uncertain:
                keep = jnp.ones(n, dtype=bool)
                if pad is not None:
                    keep = keep & ~pad
                if want_uncertain:
                    keep = keep & ~uncertain_any
                valid = keep.astype(jnp.float32)
            for dec, result in zip(instrument.decoders, results):
                counters.append(_counters(dec, result, valid=valid))

        if instrument.multiplexing_index >= 0:
            channel_index = per_read[instrument.multiplexing_index]["decoded"]
        else:
            channel_index = jnp.zeros(n, dtype=jnp.int32)

        if pack_outputs:
            # ONE dense uint8 matrix for the whole device->host pull,
            # carrying only what the host consumes (layout: d2h_layout):
            # decoded indices, pamld confidences, chained qcfail bits and
            # the uncertain mask. Distance/argmax/branch feed only the
            # counters, which just got computed device-side.
            layout = d2h_layout(instrument, want_uncertain)
            index_dtype = jnp.int32 if layout["wide"] else jnp.int16
            parts = []
            if layout["decoded_positions"]:
                ints = jnp.stack(
                    [
                        per_read[k]["decoded"].astype(index_dtype)
                        for k in layout["decoded_positions"]
                    ],
                    axis=1,
                )
                parts.append(
                    jax.lax.bitcast_convert_type(ints, jnp.uint8).reshape(
                        n, -1
                    )
                )
            if layout["confidence_positions"]:
                floats = jnp.stack(
                    [
                        per_read[k]["confidence"]
                        for k in layout["confidence_positions"]
                    ],
                    axis=1,
                )
                parts.append(
                    jax.lax.bitcast_convert_type(floats, jnp.uint8).reshape(
                        n, -1
                    )
                )
            qc_bytes = []
            for byte in range(layout["qcfail_bytes"]):
                bits = jnp.zeros(n, dtype=jnp.uint8)
                for bit in range(min(8, len(per_read) - byte * 8)):
                    bits = bits | (
                        per_read[byte * 8 + bit]["qcfail"].astype(jnp.uint8)
                        << bit
                    )
                qc_bytes.append(bits)
            parts.append(jnp.stack(qc_bytes, axis=1))
            if want_uncertain:
                parts.append(uncertain_any.astype(jnp.uint8)[:, None])
            blob = jnp.concatenate(parts, axis=1)
            # ship the decision blob FLAT: a backend may give a narrow
            # 2-D uint8 array a padded tiled device layout, and the D2H
            # pull would transfer the padding. The reshape relayouts once
            # on device; the host reshapes the dense bytes back.
            packed = {"blob": blob.reshape(-1)}
            if want_counters:
                flat = flatten_counters(instrument, counters)
                if axis_name is not None:
                    flat = jax.lax.psum(flat, axis_name)
                return packed, flat
            return packed, counters

        per_read_out = {
            "decoders": per_read,
            "qcfail": qcfail,
            "channel_index": channel_index,
        }
        if axis_name is not None and want_counters:
            counters = jax.lax.psum(counters, axis_name)
        return per_read_out, counters

    return step


def make_sharded_decode_step(
    instrument: DeviceInstrument,
    mesh: Mesh,
    jit: bool = True,
    want_uncertain: bool = False,
    want_counters: bool = True,
    pack_outputs: bool = False,
    h2d_widths: list[int] | None = None,
    qual_bits: int = 6,
):
    """SPMD decode step over a 1-D ``reads`` mesh axis.

    Batches must be padded to a multiple of the axis size; per-read outputs
    come back sharded along ``reads``, counters come back replicated (the
    psum-merged global statistics).
    """
    (axis_name,) = mesh.axis_names
    step = make_decode_step(
        instrument,
        axis_name=axis_name,
        want_uncertain=want_uncertain,
        want_counters=want_counters,
        pack_outputs=pack_outputs,
        h2d_widths=h2d_widths,
        qual_bits=qual_bits,
    )
    if h2d_widths is not None and qual_bits != 6:
        # the codebooks are replicated; the blob shards over reads
        batch_spec = {"blob": P(axis_name), "qcb": P()}
        if qual_bits == JOINT4:
            batch_spec["ccb"] = P()
    else:
        batch_spec = P(axis_name)
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(batch_spec,),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )
    if jit:
        sharded = jax.jit(sharded)
    return sharded


def pad_batch(batch: dict, multiple: int) -> tuple[dict, int]:
    """Pad every per-read leaf up to a multiple of `multiple` along axis 0.

    Padding reads have zero codes/qualities/lengths and qcfail=True; the
    host discards rows >= the true count after the step returns, and
    counter deltas for padding rows are subtracted by the caller (padding
    reads decode deterministically to unclassified row 0)."""
    n = batch["qcfail"].shape[0]
    padded_n = -(-n // multiple) * multiple
    if padded_n == n:
        return batch, n

    def pad(leaf):
        pad_width = [(0, padded_n - n)] + [(0, 0)] * (leaf.ndim - 1)
        return jnp.pad(leaf, pad_width)

    padded = {
        "segments": [
            (pad(c), pad(q), pad(l)) for c, q, l in batch["segments"]
        ],
        "qcfail": jnp.pad(
            batch["qcfail"], (0, padded_n - n), constant_values=True
        ),
    }
    return padded, n


def make_tp_sharded_decode_step(
    instrument: DeviceInstrument,
    mesh: Mesh,
    want_uncertain: bool = False,
    want_counters: bool = True,
    pack_outputs: bool = False,
    h2d_widths: list[int] | None = None,
    shard_threshold: int = 1 << 14,
    qual_bits: int = 6,
):
    """SPMD decode step over a 2-D ``(reads, panel)`` mesh: reads shard
    over the first axis, and every PAMLD panel above ``shard_threshold``
    barcodes shards its likelihood matrix over the second (barcode-axis
    tensor parallelism — for whitelists beyond one chip's HBM, see
    device/tp.py for the merge algebra). Returns (step, shard_panels)
    where ``shard_panels(device_put)`` builds the panel-shard argument
    dict to pass as ``batch["panel_shards"]``.
    """
    reads_axis, panel_axis = mesh.axis_names
    panel_size = mesh.shape[panel_axis]

    sharded_positions = [
        position
        for position, dec in enumerate(instrument.decoders)
        if dec.algorithm == "pamld" and dec.barcode_count > shard_threshold
    ]

    step = make_decode_step(
        instrument,
        axis_name=reads_axis,
        want_uncertain=want_uncertain,
        want_counters=want_counters,
        pack_outputs=pack_outputs,
        h2d_widths=h2d_widths,
        panel_axis=panel_axis,
        qual_bits=qual_bits,
    )

    def wrapped(batch, panel_shards):
        local = {}
        for key, (matrix, concentration) in panel_shards.items():
            base = (
                jax.lax.axis_index(panel_axis) * matrix.shape[1]
            ).astype(jnp.int32)
            local[key] = (matrix, concentration, base)
        batch = dict(batch)
        batch["panel_shards"] = local
        return step(batch)

    shard_specs = {
        str(position): (P(None, panel_axis), P(panel_axis))
        for position in sharded_positions
    }
    if h2d_widths is not None and qual_bits != 6:
        batch_spec = {"blob": P(reads_axis), "qcb": P()}
        if qual_bits == JOINT4:
            batch_spec["ccb"] = P()
    else:
        batch_spec = P(reads_axis)
    sharded = jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(batch_spec, shard_specs),
        out_specs=(P(reads_axis), P()),
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def shard_panels():
        """device_put each large panel's matrix/concentration with the
        panel-axis sharding (padded to a multiple of the axis size)."""
        import numpy as np
        from jax.sharding import NamedSharding

        shards = {}
        for position in sharded_positions:
            dec = instrument.decoders[position]
            matrix = np.asarray(dec.likelihood_matrix)
            concentration = np.asarray(dec.concentration)
            b = matrix.shape[1]
            padded = -(-b // panel_size) * panel_size
            if padded != b:
                matrix = np.pad(matrix, ((0, 0), (0, padded - b)))
                concentration = np.pad(concentration, (0, padded - b))
            shards[str(position)] = (
                jax.device_put(
                    matrix, NamedSharding(mesh, P(None, panel_axis))
                ),
                jax.device_put(
                    concentration, NamedSharding(mesh, P(panel_axis))
                ),
            )
        return shards

    return jitted, shard_panels, sharded_positions
