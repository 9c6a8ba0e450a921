"""IUPAC ambiguous nucleotide encoding.

The canonical on-device encoding is the standard BAM 4-bit nucleotide code
widened to uint8 (a bitmask over {A=1, C=2, G=4, T=8}; ambiguity codes are
unions of those bits, '=' is 0 and N is 15). This matches the data model the
reference builds its Phred substitution lookup around (reference iupac.h),
and every table here is a NumPy array so read batches vectorize directly
into int8 tensors for the device programs.

Code assignments (standard hts/BAM nibble order):
    0  '='   4 'G'    8 'T'   12 'K' (G|T)
    1  'A'   5 'R'    9 'W'   13 'D' (A|G|T)
    2  'C'   6 'S'   10 'Y'   14 'B' (C|G|T)
    3  'M'   7 'V'   11 'H'   15 'N' (any)
"""

from __future__ import annotations

import numpy as np

#: BAM nibble code -> IUPAC ASCII character
BAM_TO_ASCII_STR = "=ACMGRSVTWYHKDBN"
BAM_TO_ASCII = np.frombuffer(BAM_TO_ASCII_STR.encode("ascii"), dtype=np.uint8).copy()

#: ASCII byte -> BAM nibble code. Unknown characters map to 15 (N), '=' to 0.
ASCII_TO_BAM = np.full(256, 15, dtype=np.uint8)
for _code, _char in enumerate(BAM_TO_ASCII_STR):
    ASCII_TO_BAM[ord(_char)] = _code
    ASCII_TO_BAM[ord(_char.lower())] = _code
ASCII_TO_BAM[ord("=")] = 0
# U (uracil) behaves like T in hts parsing
ASCII_TO_BAM[ord("U")] = 8
ASCII_TO_BAM[ord("u")] = 8

#: BAM nibble code -> reverse complement BAM nibble code.
#: Complement of a bitmask is the bitmask with A<->T and C<->G swapped,
#: i.e. the 4-bit word reversed.
BAM_REVERSE_COMPLEMENT = np.array(
    [int(f"{code:04b}"[::-1], 2) for code in range(16)], dtype=np.uint8
)

#: codes that are a concrete, unambiguous nucleotide call
STRICT_BAM_CODES = frozenset((1, 2, 4, 8))

IS_STRICT_BAM = np.zeros(16, dtype=bool)
for _code in STRICT_BAM_CODES:
    IS_STRICT_BAM[_code] = True


def encode_ascii(sequence: bytes | str) -> np.ndarray:
    """ASCII nucleotide string -> uint8 BAM code vector."""
    if isinstance(sequence, str):
        sequence = sequence.encode("ascii")
    return ASCII_TO_BAM[np.frombuffer(sequence, dtype=np.uint8)]


def decode_ascii(codes: np.ndarray) -> str:
    """uint8 BAM code vector -> ASCII nucleotide string."""
    return BAM_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a BAM code vector."""
    return BAM_REVERSE_COMPLEMENT[np.asarray(codes, dtype=np.uint8)[::-1]]


def is_iupac_strict(codes: np.ndarray) -> bool:
    """True when every code is a concrete A/C/G/T call."""
    return bool(IS_STRICT_BAM[np.asarray(codes, dtype=np.uint8)].all())
