"""Phred quality probability model and the substitution quality lookup table.

The decoding kernels consume a dense LUT: for (quality q, expected code e,
observed code o) the "substitution quality" is

  * match (e == o, both concrete A/C/G/T):  -10*log10(1 - 10^(-q/10))
    (the phred scale of the probability that a correct call was made)
  * mismatch (e != o, both concrete):        q
    (probability the observed base is an error is 10^(-q/10))
  * anything involving an ambiguity code:    10*log10(4)
    (uniform base probability 1/4)
  * q == 0:                                  0.0

The q==0 row models the reference's behavior for positions past the end of
a short observation: the C++ reads the NUL terminator (code 0, quality 0)
and its zero-initialized lookup entries for quality 0, contributing nothing
to the sum (reference phred.cpp:39-72 initializes q in [1,0x80) only; the
singleton has static storage so q==0 entries are zero; reference
barcode.h:131-164 iterates over the *expected* length).

The table is materialized once in float64 for the exact (strict) engine and
exported as float32 for the device programs.
"""

from __future__ import annotations

import numpy as np

#: SAM/FASTQ ASCII offset for phred scores
SAM_PHRED_DECODING_OFFSET = 33
MIN_PHRED_VALUE = 2
MAX_PHRED_VALUE = 104
EFFECTIVE_PHRED_RANGE = 42

#: 10*log10(4): phred scale of a uniform 1/4 base probability
UNIFORM_BASE_QUALITY = 10.0 * np.log10(4.0)
#: 10^(-1/10): probability = PHRED_PROBABILITY_BASE ** phred
PHRED_PROBABILITY_BASE = float(pow(10.0, -0.1))

_NQ = 0x80  # quality axis size (7-bit phred)


def _build_tables():
    q = np.arange(_NQ, dtype=np.float64)
    false_positive = np.zeros(_NQ, dtype=np.float64)
    false_positive[1:] = np.power(10.0, -0.1 * q[1:])
    true_positive = np.zeros(_NQ, dtype=np.float64)
    true_positive[1:] = 1.0 - false_positive[1:]
    true_positive_quality = np.zeros(_NQ, dtype=np.float64)
    true_positive_quality[1:] = -10.0 * np.log10(true_positive[1:])

    lut = np.zeros((_NQ, 16, 16), dtype=np.float64)
    strict = (1, 2, 4, 8)
    for qq in range(1, _NQ):
        # default: anything involving ambiguity codes
        lut[qq, :, :] = UNIFORM_BASE_QUALITY
        for e in strict:
            for o in strict:
                if e == o:
                    lut[qq, e, o] = true_positive_quality[qq]
                else:
                    lut[qq, e, o] = float(qq)
    return false_positive, true_positive, true_positive_quality, lut


(
    #: P(error | q) = 10^(-q/10); zero at q=0
    FALSE_POSITIVE_PROBABILITY,
    #: P(correct | q) = 1 - 10^(-q/10); zero at q=0
    TRUE_POSITIVE_PROBABILITY,
    #: -10*log10(P(correct | q)); zero at q=0
    TRUE_POSITIVE_QUALITY,
    #: (quality, expected, observed) -> substitution quality, float64
    SUBSTITUTION_LUT,
) = _build_tables()

#: float32 export of the LUT for device kernels, shape (128, 16, 16)
SUBSTITUTION_LUT_F32 = SUBSTITUTION_LUT.astype(np.float32)

#: flat (128*16*16,) view keyed by (q << 8 | e << 4 | o) for scalar paths
SUBSTITUTION_LUT_FLAT = SUBSTITUTION_LUT.reshape(-1)


def substitution_quality(expected: int, observed: int, quality: int) -> float:
    return float(SUBSTITUTION_LUT[quality, expected, observed])


def probability_of_quality(quality) -> np.ndarray:
    return FALSE_POSITIVE_PROBABILITY[quality]
