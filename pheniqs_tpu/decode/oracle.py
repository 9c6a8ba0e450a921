"""Exact float64 decode engines (the "strict" fidelity path).

These NumPy engines replicate the reference's double-precision semantics
bit for bit — Kahan-compensated summation in the same order (reference
barcode.h:131-164, pamld.cpp:37-123), `pow(10^-0.1, sigma_q)` through the
platform libm, and the serial observation-scratch reuse that makes
observations shorter than the expected barcode deterministic (see
ObservationScratch). They serve three roles:

  1. the `--fidelity strict` execution path, producing byte-identical SAM
     tags and reports vs the reference;
  2. the oracle that unit tests compare the f32 device path against;
  3. the resolver for boundary reads the fast path flags as too close to a
     filter threshold to decide in f32.

Everything is vectorized over the batch; per-base and per-barcode loops are
over small static extents (barcode width, panel size).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..phred import PHRED_PROBABILITY_BASE, SUBSTITUTION_LUT
from ..transform import SegmentBatch
from .spec import DecoderSpec

# branch codes for accumulator updates
BRANCH_PASS = 0
BRANCH_LOW_CONFIDENCE = 1
BRANCH_NOISE = 2


class ObservationScratch:
    """Replicates the reference's per-decoder observation buffer reuse.

    The reference extracts each observation into a persistent per-thread
    buffer and terminates it with a NUL (code 0, quality 0); positions past
    the terminator keep whatever an earlier read left there (reference
    sequence.h:61-67, transform.h:142-169). The PAMLD likelihood iterates
    over the *expected* barcode length, so for observations shorter than
    the barcode those stale positions (or the zero terminator) enter the
    sum. With a single decoding thread this is fully deterministic in
    stream order; this class reproduces it vectorized.

    State per observation segment: the final buffer content (width W) after
    the last read of the previous batch.
    """

    def __init__(self, widths: list[int]):
        self.code = [np.zeros(w, dtype=np.uint8) for w in widths]
        self.quality = [np.zeros(w, dtype=np.uint8) for w in widths]

    def effective(self, segment_index: int, batch: SegmentBatch):
        """Return (code, quality) of shape (N, W) as the likelihood kernel
        would see them, then advance the scratch state."""
        w = batch.width
        n = batch.length.shape[0]
        carry_code = self.code[segment_index]
        carry_qual = self.quality[segment_index]
        if w == 0 or n == 0:
            return batch.code, batch.quality
        if int(batch.length.min()) >= w:
            # full-width fast path (the overwhelmingly common stream: no
            # read shorter than the token): every position holds fresh
            # data, so the effective view IS the raw batch and the
            # carry-out is simply the final row. The per-position scan
            # below costs O(N*W) per decoder per batch (~160 ms/131k
            # measured via PHENIQS_TRACE `scratch`); this path is two row
            # copies.
            carry_code[:] = batch.code[-1, :w]
            carry_qual[:] = batch.quality[-1, :w]
            return batch.code, batch.quality

        # extended rows: row 0 = carry-in (writes every position), rows 1..N
        length_ext = np.empty(n + 1, dtype=np.int64)
        length_ext[0] = w + 1
        length_ext[1:] = batch.length
        code_ext = np.vstack([carry_code[None, :], batch.code])
        qual_ext = np.vstack([carry_qual[None, :], batch.quality])

        eff_code = np.zeros((n, w), dtype=np.uint8)
        eff_qual = np.zeros((n, w), dtype=np.uint8)
        rows = np.arange(n + 1)
        for p in range(w):
            wrote = length_ext >= p
            writer = np.where(wrote, rows, -1)
            last = np.maximum.accumulate(writer)[1:]  # for output rows 0..N-1
            is_data = length_ext[last] > p
            eff_code[:, p] = np.where(is_data, code_ext[last, p], 0)
            eff_qual[:, p] = np.where(is_data, qual_ext[last, p], 0)
            # carry-out: last writer over all rows
            final = np.maximum.accumulate(writer)[-1]
            if length_ext[final] > p:
                carry_code_p = code_ext[final, p]
                carry_qual_p = qual_ext[final, p]
            else:
                carry_code_p = 0
                carry_qual_p = 0
            self.code[segment_index][p] = carry_code_p
            self.quality[segment_index][p] = carry_qual_p
        return eff_code, eff_qual


def kahan_sum_ordered(terms: np.ndarray, axis: int = -1) -> np.ndarray:
    """Kahan-compensated sum along `axis`, in index order, elementwise over
    the remaining axes — the vectorized equivalent of the reference's
    per-value compensated loop."""
    terms = np.moveaxis(terms, axis, 0)
    sigma = np.zeros(terms.shape[1:], dtype=np.float64)
    compensation = np.zeros_like(sigma)
    for j in range(terms.shape[0]):
        y = terms[j] - compensation
        t = sigma + y
        compensation = (t - sigma) - y
        sigma = t
    return sigma


@dataclass
class ClassifyResult:
    """Per-read outputs of one classifier over one batch."""

    decoded: np.ndarray  # (N,) int32; 0 = unclassified, 1..B = codec order
    confidence: np.ndarray  # (N,) float64 decoding confidence (0 if filtered)
    edit_distance: np.ndarray  # (N,) int32
    qcfail: np.ndarray  # (N,) bool - qcfail state AFTER this classifier
    branch: np.ndarray  # (N,) int8 - BRANCH_* for accumulator updates
    argmax: np.ndarray  # (N,) int32 - pre-noise-filter argmax (for counters)
    observation: list[SegmentBatch] = field(default_factory=list)


def pamld_likelihoods(
    spec: DecoderSpec,
    obs_code: np.ndarray,
    obs_qual: np.ndarray,
    chunk: int = 4096,
):
    """sigma_q (Kahan f64), hamming distance and high-quality distance for
    every (read, barcode) pair. obs_* are effective (N, W) arrays."""
    panel = spec.panel
    codes = panel.codes  # (B, W)
    n = obs_code.shape[0]
    b, w = codes.shape
    sigma_q = np.empty((n, b), dtype=np.float64)
    distance = np.empty((n, b), dtype=np.int32)
    hq_distance = np.empty((n, b), dtype=np.int32)
    hq_threshold = spec.high_quality_threshold
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        oc = obs_code[lo:hi, None, :]  # (n, 1, W)
        oq = obs_qual[lo:hi, None, :].astype(np.int64)
        ec = codes[None, :, :]  # (1, B, W)
        terms = SUBSTITUTION_LUT[oq, ec.astype(np.int64), oc.astype(np.int64)]
        sigma_q[lo:hi] = kahan_sum_ordered(terms, axis=-1)
        mismatch = oc != ec
        distance[lo:hi] = mismatch.sum(axis=-1, dtype=np.int32)
        hq_distance[lo:hi] = (mismatch & (oq >= hq_threshold)).sum(
            axis=-1, dtype=np.int32
        )
    return sigma_q, distance, hq_distance


def pamld_classify(
    spec: DecoderSpec,
    obs_code: np.ndarray,
    obs_qual: np.ndarray,
    qcfail_in: np.ndarray,
) -> ClassifyResult:
    """Vectorized PamlDecoder::classify (reference pamld.cpp:37-123)."""
    panel = spec.panel
    n = obs_code.shape[0]
    b = panel.cardinality

    # native C++ fast path: the same float64 LUT gathers, Kahan orders and
    # libm pow — bit-exact with the NumPy path below (golden-gated)
    from ..native import pamld_classify_native

    native = pamld_classify_native(
        obs_code,
        obs_qual,
        panel.codes,
        panel.concentration,
        SUBSTITUTION_LUT,
        spec.noise * spec.random_barcode_probability,
        spec.random_barcode_probability,
        spec.confidence_threshold,
        spec.high_quality_threshold,
        spec.high_quality_distance_threshold,
        qcfail_in,
    )
    if native is not None:
        decoded_n, confidence_n, distance_n, qcfail_n, branch_n, argmax_n = native
        return ClassifyResult(
            decoded=decoded_n,
            confidence=confidence_n,
            edit_distance=distance_n,
            qcfail=qcfail_n | qcfail_in,
            branch=branch_n,
            argmax=argmax_n,
        )

    sigma_q, distance, hq_distance = pamld_likelihoods(spec, obs_code, obs_qual)
    conditional = np.power(PHRED_PROBABILITY_BASE, sigma_q)  # (N, B) f64
    prior_adjusted = conditional * panel.concentration[None, :]

    # Kahan over barcodes in codec order + strict argmax (first max wins)
    sigma_p = np.zeros(n, dtype=np.float64)
    compensation = np.zeros(n, dtype=np.float64)
    best_p = np.zeros(n, dtype=np.float64)
    best_index = np.zeros(n, dtype=np.int32)  # 1-based; 0 until any p > 0
    for j in range(b):
        p = prior_adjusted[:, j]
        y = p - compensation
        t = sigma_p + y
        compensation = (t - sigma_p) - y
        sigma_p = t
        better = p > best_p
        best_p = np.where(better, p, best_p)
        best_index = np.where(better, np.int32(j + 1), best_index)

    adjusted_noise = spec.noise * spec.random_barcode_probability
    y = adjusted_noise - compensation
    t = sigma_p + y
    sigma_p = t

    confidence = best_p / sigma_p

    rows = np.arange(n)
    best0 = np.maximum(best_index - 1, 0)
    conditional_decoded = conditional[rows, best0]
    dist_decoded = distance[rows, best0].astype(np.int32)
    hqd_decoded = hq_distance[rows, best0].astype(np.int32)
    # if no barcode had p > 0 nothing was decoded; conditional stays 0
    none_decoded = best_index == 0
    conditional_decoded = np.where(none_decoded, 0.0, conditional_decoded)
    dist_decoded = np.where(none_decoded, 0, dist_decoded)
    hqd_decoded = np.where(none_decoded, 0, hqd_decoded)

    passed_noise = conditional_decoded > spec.random_barcode_probability
    passed_confidence = confidence > spec.confidence_threshold

    qcfail = qcfail_in.copy()
    branch = np.full(n, BRANCH_PASS, dtype=np.int8)
    decoded = best_index.copy()
    out_confidence = confidence.copy()
    out_distance = dist_decoded.copy()

    # noise filter: revert to unclassified
    noise_filtered = ~passed_noise
    branch[noise_filtered] = BRANCH_NOISE
    qcfail |= noise_filtered
    decoded[noise_filtered] = 0
    out_confidence[noise_filtered] = 0.0
    out_distance[noise_filtered] = 0

    # confidence filter
    low_confidence = passed_noise & ~passed_confidence
    branch[low_confidence] = BRANCH_LOW_CONFIDENCE
    qcfail |= low_confidence

    # high-quality mismatch filter (only in the passing branch)
    if spec.high_quality_distance_threshold > 0:
        hq_fail = (
            passed_noise
            & passed_confidence
            & (hqd_decoded >= spec.high_quality_distance_threshold)
        )
        qcfail |= hq_fail

    return ClassifyResult(
        decoded=decoded.astype(np.int32),
        confidence=out_confidence,
        edit_distance=out_distance.astype(np.int32),
        qcfail=qcfail,
        branch=branch,
        argmax=best_index.astype(np.int32),
    )


def mdd_classify(
    spec: DecoderSpec,
    observation: list[SegmentBatch],
    qcfail_in: np.ndarray,
) -> ClassifyResult:
    """Vectorized MdDecoder::classify (reference mdd.cpp:37-86).

    Distances iterate over the *observation* length (reference
    sequence.h:90-98), exact match requires equal flat strings, and the
    first barcode in codec order within tolerance wins — not the closest.
    """
    panel = spec.panel
    n = observation[0].length.shape[0]
    b = panel.cardinality
    slices = panel.segment_slices()

    # native C++ fast path (integer-exact; golden-gated like the python path)
    from ..native import mdd_classify_native

    native = mdd_classify_native(
        [seg.code for seg in observation],
        [seg.quality for seg in observation],
        [seg.length for seg in observation],
        panel.codes,
        [sl.stop - sl.start for sl in slices],
        list(spec.distance_tolerance)
        if spec.distance_tolerance
        else [0] * len(slices),
        spec.quality_masking_threshold,
        qcfail_in,
    )
    if native is not None:
        decoded_n, distance_n, qcfail_n = native
        return ClassifyResult(
            decoded=decoded_n,
            confidence=np.zeros(n, dtype=np.float64),
            edit_distance=distance_n,
            qcfail=qcfail_n | qcfail_in,
            branch=np.full(n, BRANCH_PASS, dtype=np.int8),
            argmax=decoded_n.copy(),
            observation=observation,
        )

    per_segment_error = np.zeros((n, b, len(slices)), dtype=np.int32)
    exact = np.ones((n, b), dtype=bool)
    for s, sl in enumerate(slices):
        seg = observation[s]
        codes = panel.codes[:, sl]  # (B, Ws)
        ws = seg.width
        offsets = np.arange(ws)[None, :]
        in_range = offsets < seg.length[:, None]  # (N, Ws)
        mismatch = seg.code[:, None, :] != codes[None, :, : ws if ws else 0]
        if codes.shape[1] > ws:
            # observation buffer narrower than barcode: positions beyond can
            # never match, but distance_from never reaches them (iterates
            # over observation length)
            pass
        counted = mismatch & in_range[:, None, :]
        if spec.quality_masking_threshold > 0:
            masked = (seg.quality < spec.quality_masking_threshold) & in_range
            counted = (masked[:, None, :] | mismatch) & in_range[:, None, :]
        per_segment_error[:, :, s] = counted.sum(axis=-1, dtype=np.int32)
        # exact match: full length equality against the barcode segment
        exact &= (seg.length[:, None] == codes.shape[1]) & ~(
            (mismatch & in_range[:, None, :]).any(axis=-1)
        )

    tolerance = np.array(
        spec.distance_tolerance
        if spec.distance_tolerance
        else [0] * len(slices),
        dtype=np.int32,
    )
    within = (per_segment_error <= tolerance[None, None, :]).all(axis=-1)
    total_error = per_segment_error.sum(axis=-1, dtype=np.int32)

    exact_any = exact.any(axis=1)
    exact_first = exact.argmax(axis=1)
    scan_any = within.any(axis=1)
    scan_first = within.argmax(axis=1)

    decoded = np.zeros(n, dtype=np.int32)
    distance = np.zeros(n, dtype=np.int32)
    decoded[exact_any] = exact_first[exact_any] + 1
    use_scan = ~exact_any & scan_any
    decoded[use_scan] = scan_first[use_scan] + 1
    distance[use_scan] = total_error[use_scan, scan_first[use_scan]]

    unclassified = decoded == 0
    qcfail = qcfail_in | unclassified
    return ClassifyResult(
        decoded=decoded,
        confidence=np.zeros(n, dtype=np.float64),
        edit_distance=distance,
        qcfail=qcfail,
        branch=np.full(n, BRANCH_PASS, dtype=np.int8),
        argmax=decoded.copy(),
        observation=observation,
    )
