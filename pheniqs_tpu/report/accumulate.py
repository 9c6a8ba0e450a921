"""Per-barcode and per-decoder statistics accumulators.

The analog of the reference's thread-local accumulators merged
at collect time (reference selector.h:32-92, selector.cpp:25-247): counters
live in NumPy arrays indexed by barcode (row 0 = unclassified), batch
updates use order-preserving `np.add.at` so double sums replicate the
serial `+=` ordering bit for bit, and cross-chip/cross-host merging is a
plain elementwise sum (allreduce-friendly: every field is a sum).

Precision note: the strict engine feeds these accumulators f64 values and
reproduces the reference's report doubles exactly (golden-gated). The
device engines instead merge per-batch counter deltas computed ON DEVICE
(device/step.py counter_layout): counts are exact (small integers in f32
stay exact far beyond any batch size), but per-barcode confidence sums
accumulate within a batch in f32 before the host widens to f64 — so
`average classified confidence` style report fields in fast/hybrid modes
can differ from strict in low-order digits (~1e-6 relative per batch)
even though every DECISION is strict-identical under hybrid. Tests pin
count-level exactness across engines (tests/test_hybrid.py).
"""

from __future__ import annotations

import numpy as np


class DecoderAccumulator:
    """Statistics for one classifier: barcode rows 0..B (0 = unclassified)
    plus the decoder-level aggregate, with the reference's finalize math."""

    def __init__(self, index: int, barcode_cardinality: int):
        self.index = index
        n = barcode_cardinality + 1
        self.count = np.zeros(n, dtype=np.int64)
        self.pf_count = np.zeros(n, dtype=np.int64)
        self.accumulated_distance = np.zeros(n, dtype=np.int64)
        self.accumulated_pf_distance = np.zeros(n, dtype=np.int64)
        self.accumulated_confidence = np.zeros(n, dtype=np.float64)
        self.accumulated_pf_confidence = np.zeros(n, dtype=np.float64)
        self.low_conditional_confidence_count = np.zeros(n, dtype=np.int64)
        self.low_confidence_count = np.zeros(n, dtype=np.int64)

    @property
    def cardinality(self) -> int:
        return self.count.shape[0] - 1

    def collect(self, other: "DecoderAccumulator"):
        """Merge another accumulator (thread/chip/host local copy)."""
        self.count += other.count
        self.pf_count += other.pf_count
        self.accumulated_distance += other.accumulated_distance
        self.accumulated_pf_distance += other.accumulated_pf_distance
        self.accumulated_confidence += other.accumulated_confidence
        self.accumulated_pf_confidence += other.accumulated_pf_confidence
        self.low_conditional_confidence_count += other.low_conditional_confidence_count
        self.low_confidence_count += other.low_confidence_count

    # --- partial-run serialization (PHENIQS_SHARD merge workflow) ----------
    _STATE_FIELDS = (
        "count",
        "pf_count",
        "accumulated_distance",
        "accumulated_pf_distance",
        "accumulated_confidence",
        "accumulated_pf_confidence",
        "low_conditional_confidence_count",
        "low_confidence_count",
    )

    def state_dict(self) -> dict:
        """JSON-safe raw sums; every field merges by elementwise addition."""
        return {
            name: getattr(self, name).tolist() for name in self._STATE_FIELDS
        }

    def merge_state(self, state: dict):
        for name in self._STATE_FIELDS:
            values = np.asarray(state[name])
            target = getattr(self, name)
            if values.shape != target.shape:
                raise ValueError(
                    f"partial accumulator {name} cardinality "
                    f"{values.shape} != {target.shape}"
                )
            target += values.astype(target.dtype)

    # --- batch updates ------------------------------------------------------
    def update_counts(self, decoded: np.ndarray, qcfail: np.ndarray):
        np.add.at(self.count, decoded, 1)
        np.add.at(self.pf_count, decoded[~qcfail], 1)

    def update_distance(self, decoded: np.ndarray, distance: np.ndarray, qcfail: np.ndarray):
        classified = (decoded > 0) & (distance > 0)
        np.add.at(self.accumulated_distance, decoded[classified], distance[classified])
        pf = classified & ~qcfail
        np.add.at(self.accumulated_pf_distance, decoded[pf], distance[pf])

    def update_confidence(self, decoded, confidence, passed, qcfail):
        """`passed` marks reads in the high-confidence branch; pf adds only
        when the read is not (yet) qc-failed."""
        np.add.at(self.accumulated_confidence, decoded[passed], confidence[passed])
        pf = passed & ~qcfail
        np.add.at(self.accumulated_pf_confidence, decoded[pf], confidence[pf])

    def update_filters(self, argmax, low_confidence, noise_filtered):
        np.add.at(self.low_confidence_count, argmax[low_confidence], 1)
        np.add.at(
            self.low_conditional_confidence_count, argmax[noise_filtered], 1
        )

    # --- finalize -----------------------------------------------------------
    def finalize(self) -> dict:
        """Compute decoder-level aggregates and per-barcode derived fields,
        plus noise/concentration prior estimates (reference
        classifier.h:94-124, pamld.h:40-48, decoder.h:77-83)."""
        out: dict = {}
        classified_count = int(self.count[1:].sum())
        pf_classified_count = int(self.pf_count[1:].sum())
        count = classified_count + int(self.count[0])
        pf_count = pf_classified_count + int(self.pf_count[0])

        accumulated_classified_distance = int(self.accumulated_distance[1:].sum())
        accumulated_pf_classified_distance = int(self.accumulated_pf_distance[1:].sum())
        accumulated_classified_confidence = float(self.accumulated_confidence[1:].sum())
        accumulated_pf_classified_confidence = float(
            self.accumulated_pf_confidence[1:].sum()
        )
        low_conditional = int(self.low_conditional_confidence_count.sum())
        low_confidence = int(self.low_confidence_count.sum())

        out["index"] = self.index
        out["count"] = count
        out["pf count"] = pf_count
        out["classified count"] = classified_count
        out["low conditional confidence count"] = low_conditional
        out["low confidence count"] = low_confidence
        out["pf classified count"] = pf_classified_count

        pf_fraction = pf_count / count if count > 0 else 0.0
        classified_fraction = classified_count / count if count > 0 else 0.0
        out["pf fraction"] = pf_fraction
        out["classified fraction"] = classified_fraction
        if classified_count > 0:
            out["average classified distance"] = (
                accumulated_classified_distance / classified_count
            )
            out["average classified confidence"] = (
                accumulated_classified_confidence / classified_count
            )
            out["classified pf fraction"] = pf_classified_count / classified_count
        else:
            out["average classified distance"] = 0.0
            out["average classified confidence"] = 0.0
            out["classified pf fraction"] = 0.0
        out["pf classified fraction"] = (
            pf_classified_count / pf_count if pf_count > 0 else 0.0
        )
        if pf_classified_count > 0:
            out["average pf classified distance"] = (
                accumulated_pf_classified_distance / pf_classified_count
            )
            out["average pf classified confidence"] = (
                accumulated_pf_classified_confidence / pf_classified_count
            )
        else:
            out["average pf classified distance"] = 0.0
            out["average pf classified confidence"] = 0.0

        # noise prior estimation (reference classifier.h:103-119)
        estimated_noise_count = float(low_conditional)
        denominator = estimated_noise_count + pf_classified_count
        confident_noise_ratio = (
            estimated_noise_count / denominator if denominator != 0 else float("nan")
        )
        if low_confidence > 0:
            estimated_noise_count += float(low_confidence) * confident_noise_ratio
        out["estimated noise"] = (
            estimated_noise_count / float(count) if count else 0.0
        )

        # per-barcode derived fields
        barcodes = []
        estimated_not_noise = 1.0 - out["estimated noise"]
        for b in range(self.count.shape[0]):
            entry: dict = {"index": b, "count": int(self.count[b])}
            c = int(self.count[b])
            pf = int(self.pf_count[b])
            entry["pf count"] = pf
            entry["average distance"] = (
                int(self.accumulated_distance[b]) / c if c > 0 else 0.0
            )
            entry["average confidence"] = (
                float(self.accumulated_confidence[b]) / c if c > 0 else 0.0
            )
            entry["pooled fraction"] = c / count if c > 0 and count > 0 else 0.0
            entry["pooled classified fraction"] = (
                c / classified_count if c > 0 and classified_count > 0 else 0.0
            )
            entry["pf fraction"] = pf / c if pf > 0 else 0.0
            entry["average pf distance"] = (
                int(self.accumulated_pf_distance[b]) / pf if pf > 0 else 0.0
            )
            entry["average pf confidence"] = (
                float(self.accumulated_pf_confidence[b]) / pf if pf > 0 else 0.0
            )
            entry["pf pooled fraction"] = (
                pf / pf_count if pf > 0 and pf_count > 0 else 0.0
            )
            entry["pf pooled classified fraction"] = (
                pf / pf_classified_count
                if pf > 0 and pf_classified_count > 0
                else 0.0
            )
            entry["low conditional confidence count"] = int(
                self.low_conditional_confidence_count[b]
            )
            entry["low confidence count"] = int(self.low_confidence_count[b])
            if b > 0:
                entry["estimated concentration"] = (
                    estimated_not_noise * entry["pf pooled classified fraction"]
                )
            barcodes.append(entry)
        out["barcodes"] = barcodes
        return out


def encode_barcode_report(entry: dict, classified: bool) -> dict:
    """AccumulatingOption::encode field selection and order (reference
    selector.cpp:102-135)."""
    report: dict = {}
    report["count"] = entry["count"]
    if entry["average distance"] > 0:
        report["average distance"] = entry["average distance"]
    if entry["average confidence"] > 0:
        report["average confidence"] = entry["average confidence"]
    if entry["low conditional confidence count"] > 0:
        report["low conditional confidence count"] = entry[
            "low conditional confidence count"
        ]
    if entry["low confidence count"] > 0:
        report["low confidence count"] = entry["low confidence count"]
    report["pooled fraction"] = entry["pooled fraction"]
    if entry["pooled classified fraction"] > 0:
        report["pooled classified fraction"] = entry["pooled classified fraction"]
    report["pf count"] = entry["pf count"]
    if entry["average pf distance"] > 0:
        report["average pf distance"] = entry["average pf distance"]
    if entry["average pf confidence"] > 0:
        report["average pf confidence"] = entry["average pf confidence"]
    report["pf fraction"] = entry["pf fraction"]
    report["pf pooled fraction"] = entry["pf pooled fraction"]
    if entry["pf pooled classified fraction"] > 0:
        report["pf pooled classified fraction"] = entry[
            "pf pooled classified fraction"
        ]
    if classified and entry.get("estimated concentration", 0) > 0:
        report["estimated concentration"] = entry["estimated concentration"]
    report["index"] = entry["index"]
    return report


def encode_decoder_report(final: dict, spec) -> dict:
    """Classifier::encode: selector block + unclassified + classified array
    (reference selector.cpp:215-247, classifier.h:161-177, barcode.cpp
    Barcode::encode)."""
    report: dict = {}
    report["index"] = final["index"]
    report["count"] = final["count"]
    report["pf count"] = final["pf count"]
    report["classified count"] = final["classified count"]
    if final["low conditional confidence count"] > 0:
        report["low conditional confidence count"] = final[
            "low conditional confidence count"
        ]
    if final["low confidence count"] > 0:
        report["low confidence count"] = final["low confidence count"]
    report["pf classified count"] = final["pf classified count"]
    report["pf fraction"] = final["pf fraction"]
    report["classified fraction"] = final["classified fraction"]
    if final["average classified distance"] > 0:
        report["average classified distance"] = final["average classified distance"]
    if final["average classified confidence"] > 0:
        report["average classified confidence"] = final[
            "average classified confidence"
        ]
    report["pf classified fraction"] = final["pf classified fraction"]
    report["classified pf fraction"] = final["classified pf fraction"]
    if final["average pf classified distance"] > 0:
        report["average pf classified distance"] = final[
            "average pf classified distance"
        ]
    if final["average pf classified confidence"] > 0:
        report["average pf classified confidence"] = final[
            "average pf classified confidence"
        ]
    if final["estimated noise"] > 0:
        report["estimated noise"] = final["estimated noise"]

    barcodes = final["barcodes"]
    unclassified = encode_barcode_report(barcodes[0], classified=False)
    report["unclassified"] = unclassified

    if spec is not None and spec.panel is not None:
        classified = []
        for b in range(1, len(barcodes)):
            entry = encode_barcode_report(barcodes[b], classified=True)
            entry["concentration"] = float(spec.panel.concentration[b - 1])
            entry["barcode"] = list(spec.panel.barcode_strings[b - 1])
            classified.append(entry)
        report["classified"] = classified
    return report
