"""Synthetic flagship workload: a production-shaped demultiplexing
instrument for compile checks and benchmarks.

Models a dual-index Illumina + single-cell configuration — the union of the
reference's bundled workloads (test/BDGGG three-segment PAMLD+cellular+UMI,
example/H7LT2DSXX dual-index sample decoding): a PAMLD sample decoder over
a 96-barcode i7+i5 panel, a PAMLD cellular decoder over a 384-barcode
16 nt panel, and a naive molecular (UMI) extractor, on 4-segment reads.
"""

from __future__ import annotations

import numpy as np

from .instrument import DeviceInstrument, compile_instrument

BASES = np.array(list("ACGT"))
#: BAM 4-bit codes for A/C/G/T
BASE_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)

#: NovaSeq RTA3 emits exactly four quality values; the flagship workload
#: models that sequencer, so its synthetic qualities are binned the same
#: way (q<=2 -> 2 no-call, 3..14 -> 12, 15..30 -> 23, >=31 -> 37). This is
#: also what lets the engine's sensed 2-bit quality wire engage
#: (device/step.py wire v3), exactly as it would on real NovaSeq FASTQ.
RTA3_VALUES = (2, 12, 23, 37)


def rta3_bin(qual: np.ndarray) -> np.ndarray:
    """Quantize Phred qualities to the NovaSeq RTA3 four-value alphabet."""
    binned = np.full(qual.shape, 37, dtype=np.uint8)
    binned[qual <= 30] = 23
    binned[qual <= 14] = 12
    binned[qual <= 2] = 2
    return binned


def _random_words(rng: np.random.Generator, count: int, length: int) -> list[str]:
    seen: set[str] = set()
    words: list[str] = []
    while len(words) < count:
        word = "".join(rng.choice(BASES, size=length))
        if word not in seen:
            seen.add(word)
            words.append(word)
    return words


def _codec(words: list[str], segments: list[int], noise: float) -> dict:
    codec = {}
    for i, word in enumerate(words):
        barcode = []
        offset = 0
        for width in segments:
            barcode.append(word[offset : offset + width])
            offset += width
        codec[str(i + 1)] = {
            "barcode": barcode,
            "concentration": (1.0 - noise) / len(words),
            "index": i + 1,
        }
    return codec


def flagship_ontology(
    sample_barcodes: int = 96,
    cellular_barcodes: int = 384,
    seed: int = 20260816,
) -> dict:
    """Compiled-instruction-shaped ontology for the flagship instrument.

    Read layout (4 segments, the NovaSeq dual-index single-cell shape):
      segment 0: 150 nt biological,  segment 1: 8 nt i7,
      segment 2: 8 nt i5,            segment 3: 26 nt (16 cell + 10 UMI).
    """
    rng = np.random.default_rng(seed)
    sample_words = _random_words(rng, sample_barcodes, 16)
    cell_words = _random_words(rng, cellular_barcodes, 16)
    sample_noise = 0.05
    cell_noise = 0.05
    return {
        "input segment cardinality": 4,
        "output segment cardinality": 1,
        "sample": {
            "algorithm": "pamld",
            "index": 1,
            "multiplexing classifier": True,
            "codec": _codec(sample_words, [8, 8], sample_noise),
            "noise": sample_noise,
            "confidence threshold": 0.95,
            "random barcode probability": 1.0 / 4**16,
            "high quality threshold": 30,
            "high quality distance threshold": 0,
            "transform": {"token": ["1::8", "2::8"]},
        },
        "cellular": [
            {
                "algorithm": "pamld",
                "index": 2,
                "codec": _codec(cell_words, [16], cell_noise),
                "noise": cell_noise,
                "confidence threshold": 0.95,
                "random barcode probability": 1.0 / 4**16,
                "high quality threshold": 30,
                "high quality distance threshold": 0,
                "transform": {"token": ["3::16"]},
            }
        ],
        "molecular": [
            {
                "algorithm": "naive",
                "index": 3,
                "transform": {"token": ["3:16:26"]},
            }
        ],
    }


def flagship_instrument(**kwargs) -> DeviceInstrument:
    return compile_instrument(flagship_ontology(**kwargs))


def synthetic_batch(
    instrument: DeviceInstrument | None,
    ontology: dict,
    n: int,
    seed: int = 7,
    error_rate: float = 0.02,
    segment_widths: tuple[int, ...] = (150, 8, 8, 26),
    quality_binning: str | None = "rta3",
) -> dict:
    """Simulate a NumPy read batch drawn from the ontology's panels.

    Qualities are RTA3-binned by default (the flagship models a NovaSeq;
    pass ``quality_binning=None`` for a rich Sanger-scale alphabet).
    Panels come from the NumPy decoder specs, NOT the device instrument:
    input synthesis must never touch the accelerator (an `np.asarray` of
    a device-resident panel is a D2H pull, and a process that only
    synthesizes input must not open the card)."""
    from ..decode.spec import spec_from_ontology

    rng = np.random.default_rng(seed)
    segments = []
    sample_codes = np.asarray(
        spec_from_ontology(ontology["sample"], "sample").panel.codes,
        dtype=np.uint8,
    )
    cell_codes = np.asarray(
        spec_from_ontology(ontology["cellular"][0], "cellular").panel.codes,
        dtype=np.uint8,
    )
    draw_sample = sample_codes[rng.integers(sample_codes.shape[0], size=n)]
    draw_cell = cell_codes[rng.integers(cell_codes.shape[0], size=n)]

    def noisy(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        qual = rng.integers(12, 41, size=codes.shape).astype(np.uint8)
        err = rng.random(codes.shape) < error_rate
        sub = BASE_CODES[rng.integers(4, size=codes.shape)]
        code = np.where(err, sub, codes).astype(np.uint8)
        qual = np.where(err, rng.integers(2, 20, size=codes.shape), qual).astype(
            np.uint8
        )
        return code, qual

    for s, width in enumerate(segment_widths):
        if s == 0:
            code = BASE_CODES[rng.integers(4, size=(n, width))]
            qual = rng.integers(20, 41, size=(n, width)).astype(np.uint8)
        elif s == 1:
            code, qual = noisy(draw_sample[:, :8])
        elif s == 2:
            code, qual = noisy(draw_sample[:, 8:])
        else:
            cell_code, cell_qual = noisy(draw_cell)
            umi = BASE_CODES[rng.integers(4, size=(n, 10))]
            umi_qual = rng.integers(20, 41, size=(n, 10)).astype(np.uint8)
            code = np.concatenate([cell_code, umi], axis=1)
            qual = np.concatenate([cell_qual, umi_qual], axis=1)
        if quality_binning == "rta3":
            qual = rta3_bin(qual)
        segments.append(
            (
                code.astype(np.int32),
                qual.astype(np.int32),
                np.full(n, width, dtype=np.int32),
            )
        )
    return {
        "segments": segments,
        "qcfail": np.zeros(n, dtype=bool),
    }
