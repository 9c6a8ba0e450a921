"""Compiled decoder specifications shared by the strict (NumPy f64) engine
and the device (JAX f32) engine.

A DecoderSpec is the executable form of one classifier from the compiled
instruction document: the tokenization rule, the expected barcode panel with
priors, and the algorithm thresholds (reference decoder.h:29-84,
pamld.h:28-49, mdd.h, classifier.h:45-86).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import ConfigurationError
from ..iupac import encode_ascii
from ..transform import Rule

SAMPLE = "sample"
CELLULAR = "cellular"
MOLECULAR = "molecular"


@dataclass
class BarcodePanel:
    """The classified barcode panel of one decoder (index 1..B; index 0 is
    the undetermined tag by convention, reference barcode.h:39-45)."""

    codes: np.ndarray  # (B, W) uint8 - segments concatenated
    concentration: np.ndarray  # (B,) float64 - prior P(b)
    segment_lengths: list[int]  # widths of each barcode segment
    keys: list[str]  # codec keys, in codec order
    barcode_strings: list[list[str]]  # per-barcode per-segment ASCII

    @property
    def cardinality(self) -> int:
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        return self.codes.shape[1]

    def segment_slices(self) -> list[slice]:
        slices = []
        offset = 0
        for length in self.segment_lengths:
            slices.append(slice(offset, offset + length))
            offset += length
        return slices


@dataclass
class DecoderSpec:
    algorithm: str  # pamld | mdd | naive | passthrough
    classifier_type: str  # sample | cellular | molecular
    index: int
    rule: Rule | None
    panel: BarcodePanel | None
    multiplexing: bool = False
    # priors / thresholds
    noise: float = 0.0
    confidence_threshold: float = 0.0
    random_barcode_probability: float = 0.0
    high_quality_threshold: int = 30
    high_quality_distance_threshold: int = 0
    quality_masking_threshold: int = 0
    distance_tolerance: list[int] = field(default_factory=list)
    corrected_quality: int = 30
    # identity annotations
    rg_by_barcode_index: list[str] = field(default_factory=list)  # sample only
    ontology: dict | None = None  # compiled decoder ontology (for reports)

    @property
    def nucleotide_cardinality(self) -> int:
        return self.panel.width if self.panel is not None else 0


def build_panel(ontology: dict) -> BarcodePanel | None:
    """Build a BarcodePanel from a compiled decoder ontology's codec."""
    codec = ontology.get("codec")
    if not codec:
        return None
    keys = list(codec.keys())
    barcode_strings = [list(codec[k]["barcode"]) for k in keys]
    segment_lengths = [len(s) for s in barcode_strings[0]]
    for strings in barcode_strings:
        if [len(s) for s in strings] != segment_lengths:
            raise ConfigurationError("inconsistent barcode segment lengths in codec")
    width = sum(segment_lengths)
    codes = np.zeros((len(keys), width), dtype=np.uint8)
    for b, strings in enumerate(barcode_strings):
        offset = 0
        for segment in strings:
            codes[b, offset : offset + len(segment)] = encode_ascii(segment)
            offset += len(segment)
    concentration = np.array(
        [float(codec[k].get("concentration", 1.0)) for k in keys], dtype=np.float64
    )
    return BarcodePanel(
        codes=codes,
        concentration=concentration,
        segment_lengths=segment_lengths,
        keys=keys,
        barcode_strings=barcode_strings,
    )


def spec_from_ontology(ontology: dict, classifier_type: str) -> DecoderSpec:
    """Build a DecoderSpec from one compiled decoder ontology node."""
    algorithm = ontology.get("algorithm", "passthrough")
    rule = None
    if "transform" in ontology:
        rule = Rule.from_ontology(ontology["transform"])
    panel = build_panel(ontology)
    spec = DecoderSpec(
        algorithm=algorithm,
        classifier_type=classifier_type,
        index=int(ontology.get("index", 0)),
        rule=rule,
        panel=panel,
        multiplexing=bool(ontology.get("multiplexing classifier", False)),
        noise=float(ontology.get("noise", 0.0)),
        confidence_threshold=float(ontology.get("confidence threshold", 0.0)),
        random_barcode_probability=float(
            ontology.get("random barcode probability", 0.0)
        ),
        high_quality_threshold=int(ontology.get("high quality threshold", 30)),
        high_quality_distance_threshold=int(
            ontology.get("high quality distance threshold", 0)
        ),
        quality_masking_threshold=int(ontology.get("quality masking threshold", 0)),
        distance_tolerance=list(ontology.get("distance tolerance", [])),
        corrected_quality=int(ontology.get("corrected quality", 30)),
        ontology=ontology,
    )
    if classifier_type == SAMPLE:
        rg: list[str] = []
        undetermined = ontology.get("undetermined", {})
        rg.append(str(undetermined.get("ID", "undetermined")))
        codec = ontology.get("codec", {})
        for key in codec:
            rg.append(str(codec[key].get("ID", key)))
        spec.rg_by_barcode_index = rg
    return spec
