"""Structure-of-arrays read batches.

A ReadBatch is the unit of work flowing through the engine: N reads, each
with S segments, stored as padded uint8 code/quality matrices plus length
vectors — the host-side mirror of the tensors shipped to the device.
Variable-length metadata (names) stays on host.

This replaces the reference's per-read `Read`/`Segment` object graph
(reference read.h:28-378) with a layout the device can consume directly.
"""

from __future__ import annotations

import numpy as np

from ..transform import SegmentBatch


class ReadBatch:
    """N reads as SoA arrays. Names are held as one NUL-free byte arena
    plus (N+1) prefix offsets (the native parser's layout); the per-read
    list materializes lazily for consumers that need it."""

    __slots__ = (
        "segments",
        "qcfail",
        "names_blob",
        "name_offsets",
        "_names",
        "raw_index",
        "_shm_staged",  # (slot, layout, end) from StreamRunner.stage
        "_arena",  # shm.SlotArena when parsed straight into a slot
    )

    def __init__(
        self,
        segments: list[SegmentBatch],
        qcfail: np.ndarray,
        names: list[bytes] | None = None,
        names_blob: bytes | None = None,
        name_offsets: np.ndarray | None = None,
    ):
        self.segments = segments
        self.qcfail = qcfail
        # position in the raw ingest stream (set by pipelined engines so
        # out-of-order render results can be resequenced)
        self.raw_index: int | None = None
        if names_blob is None:
            assert names is not None
            names_blob = b"".join(names)
            name_offsets = np.zeros(len(names) + 1, dtype=np.int64)
            name_offsets[1:] = np.cumsum([len(x) for x in names])
        self.names_blob = names_blob
        self.name_offsets = name_offsets
        self._names = names

    @property
    def names(self) -> list[bytes]:
        if self._names is None:
            blob = self.names_blob
            if not isinstance(blob, (bytes, bytearray)):
                blob = blob.tobytes()  # zero-copy arenas hold uint8 views
            offsets = self.name_offsets
            self._names = [
                blob[offsets[i] : offsets[i + 1]]
                for i in range(offsets.shape[0] - 1)
            ]
        return self._names

    @property
    def size(self) -> int:
        return self.name_offsets.shape[0] - 1

    @property
    def segment_cardinality(self) -> int:
        return len(self.segments)

    def select(self, mask: np.ndarray) -> "ReadBatch":
        """Subset the batch by boolean mask, preserving order."""
        idx = np.flatnonzero(mask)
        # gather the name arena spans fully vectorized: for each output
        # byte, source = span start + position within its span
        starts = self.name_offsets[idx]
        lengths = self.name_offsets[idx + 1] - starts
        offsets = np.zeros(idx.size + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        if total:
            blob_view = (
                self.names_blob
                if isinstance(self.names_blob, np.ndarray)
                else np.frombuffer(self.names_blob, dtype=np.uint8)
            )
            within = np.arange(total, dtype=np.int64) - np.repeat(
                offsets[:-1], lengths
            )
            blob = blob_view[np.repeat(starts, lengths) + within].tobytes()
        else:
            blob = b""
        selected = ReadBatch(
            segments=[
                SegmentBatch(
                    code=s.code[idx],
                    quality=s.quality[idx],
                    length=s.length[idx],
                )
                for s in self.segments
            ],
            names_blob=blob,
            name_offsets=offsets,
            qcfail=self.qcfail[idx],
        )
        selected.raw_index = self.raw_index
        return selected

    @classmethod
    def from_records(
        cls,
        records: list[list[tuple[bytes, bytes, bytes, bool]]],
        leading_segment_index: int = 0,
    ) -> "ReadBatch":
        """Build from per-read lists of (name, sequence_ascii, quality_phred,
        qcfail) tuples, one inner list entry per segment."""
        from ..iupac import ASCII_TO_BAM

        n = len(records)
        cardinality = len(records[0]) if n else 0
        segments = []
        for s in range(cardinality):
            lengths = np.array([len(r[s][1]) for r in records], dtype=np.int32)
            width = int(lengths.max(initial=0))
            code = np.zeros((n, width), dtype=np.uint8)
            qual = np.zeros((n, width), dtype=np.uint8)
            for i, r in enumerate(records):
                seq = np.frombuffer(r[s][1], dtype=np.uint8)
                code[i, : len(seq)] = ASCII_TO_BAM[seq]
                qual[i, : len(seq)] = np.frombuffer(r[s][2], dtype=np.uint8)
            segments.append(SegmentBatch(code=code, quality=qual, length=lengths))
        names = [r[0][0] for r in records]
        # qcfail comes from the leading segment (reference read.h:262)
        qcfail = np.array(
            [r[leading_segment_index][3] for r in records], dtype=bool
        )
        return cls(segments=segments, names=names, qcfail=qcfail)
