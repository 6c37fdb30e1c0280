"""O(1)-ingest sample buffer: a deque of chunks with a sliding front.

The streaming front ends previously grew one flat numpy array per stream and
re-concatenated the WHOLE backlog on every process() call (VERDICT r4 weak
#6): an O(backlog) copy per chunk, quadratic for a producer faster than the
pipeline (the long-stream soak surfaced exactly that regime).  ChunkBuffer
appends in O(1), trims the front in O(chunks dropped), and materializes
contiguous spans only at upload-segment assembly — the one place the bytes
are actually needed (and where they are immediately quantized anyway).

This replaces the GNU Radio circular buffer in spirit (reference L1
scheduler, SURVEY §1) without its fixed capacity: the host buffer stays
unbounded by design (dropping samples is the app's decision — pace on
`Trigger.backlog`), but the per-call cost no longer scales with it.
"""

from __future__ import annotations

import numpy as np


class ChunkBuffer:
    """Append-only-at-back, trim-at-front buffer of 1-D numpy samples."""

    __slots__ = ("_chunks", "_off", "_len", "_dtype")

    def __init__(self, initial: np.ndarray | None = None,
                 dtype=np.complex64):
        self._chunks: list[np.ndarray] = []
        self._off = 0          # consumed samples of _chunks[0]
        self._len = 0          # total valid samples
        self._dtype = np.dtype(dtype)
        if initial is not None and len(initial):
            self.append(initial)

    def __len__(self) -> int:
        return self._len

    def append(self, samples: np.ndarray) -> None:
        arr = np.asarray(samples, dtype=self._dtype)
        if arr.size == 0:
            return
        self._chunks.append(arr)
        self._len += arr.size

    def drop_front(self, n: int) -> None:
        """Discard the first n samples (clamped to the buffer length)."""
        n = min(max(n, 0), self._len)
        self._len -= n
        n += self._off
        self._off = 0
        while n > 0 and self._chunks:
            c0 = self._chunks[0]
            if n >= c0.size:
                n -= c0.size
                self._chunks.pop(0)
            else:
                self._off = n
                n = 0

    def view(self, a: int, b: int) -> np.ndarray:
        """Materialize samples [a, b) (buffer-relative, 0 = current front).

        O(b - a + chunks touched); returns a fresh contiguous array (or a
        zero-copy slice when the span lies within one chunk)."""
        assert 0 <= a <= b <= self._len, (a, b, self._len)
        if a == b:
            return np.empty(0, self._dtype)
        out = None
        pos = -self._off
        need_lo, need_hi = a, b
        parts = []
        for c in self._chunks:
            lo, hi = pos, pos + c.size
            pos = hi
            if hi <= need_lo:
                continue
            if lo >= need_hi:
                break
            s = c[max(need_lo - lo, 0):min(need_hi, hi) - lo]
            if lo <= need_lo and hi >= need_hi:
                return s          # single-chunk fast path: zero copy
            parts.append(s)
        out = np.concatenate(parts)
        assert out.size == b - a
        return out

    def to_array(self) -> np.ndarray:
        """Whole buffer as one contiguous array (checkpointing only)."""
        return self.view(0, self._len)
