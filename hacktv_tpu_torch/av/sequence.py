"""Multi-input sequencing: the reference's input list loop
(src/hacktv.c:1528-1598) — inputs play in order, `--repeat` loops the
list, `--shuffle` re-orders each pass (never repeating the previous
input first, src/hacktv.c:1546-1557).

Presented as a single AV source with a continuous frame/audio timeline:
when the active input reaches EOF, the next one takes over at the
current frame; its audio is spliced at the pairs-consumed-so-far point.
"""

from __future__ import annotations

import numpy as np


class SequenceSource:
    def __init__(self, sources_or_factories, repeat: bool = False,
                 shuffle: bool = False, seed: int = 1):
        """`sources_or_factories`: list of AV sources or zero-arg
        callables returning one (so ffmpeg inputs open lazily, like the
        reference opening each input as it starts)."""
        self._items = list(sources_or_factories)
        assert self._items
        self.repeat = repeat
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._order = list(range(len(self._items)))
        if shuffle:
            self._shuffle_pass(first_pass=True)
        self._pos = 0
        self._cur = self._open(self._order[0])
        self._frame_base = 0          # first stream frame of current src
        self._audio_base = 0          # first stream audio pair of cur src
        self._ended = False
        self._last = np.zeros((self._cur.height, self._cur.width, 3),
                              dtype=np.uint8)
        self.width = self._cur.width
        self.height = self._cur.height
        self.interlaced = getattr(self._cur, "interlaced", 0)

    def _open(self, idx):
        it = self._items[idx]
        return it() if callable(it) else it

    def _shuffle_pass(self, first_pass: bool = False) -> None:
        prev_last = None if first_pass else self._order[-1]
        while True:
            self._rng.shuffle(self._order)
            # avoid replaying the same input back-to-back across passes
            if len(self._order) == 1 or self._order[0] != prev_last:
                return

    def _advance(self, at_frame: int) -> bool:
        """Switch to the next input; returns False when the list is
        exhausted (no repeat)."""
        if hasattr(self._cur, "close"):
            try:
                self._cur.close()
            except Exception:
                pass
        self._pos += 1
        if self._pos >= len(self._order):
            if not self.repeat:
                self._ended = True
                return False
            self._pos = 0
            if self.shuffle:
                self._shuffle_pass()
        self._cur = self._open(self._order[self._pos])
        self._frame_base = at_frame
        self._audio_base = self._audio_consumed
        return True

    _audio_consumed = 0

    def read_video(self, frame_no: int) -> np.ndarray:
        while not self._ended:
            local = frame_no - self._frame_base
            if not self._src_eof(local):
                self._last = self._cur.read_video(local)
                return self._last
            if not self._advance(frame_no):
                break
        return self._last      # hold the final frame after the list ends

    def _src_eof(self, local_frame: int) -> bool:
        f = getattr(self._cur, "eof", None)
        return bool(f(local_frame)) if f is not None else False

    def read_audio(self, start: int, count: int) -> np.ndarray:
        # audio follows the active input, spliced at switch points; the
        # chain pulls monotonically with bounded lookback
        self._audio_consumed = max(self._audio_consumed, start + count)
        local = max(start - self._audio_base, 0)
        return self._cur.read_audio(local, count)

    def read_cc608(self, frame_no: int):
        f = getattr(self._cur, "read_cc608", None)
        return f(frame_no - self._frame_base) if f is not None else (0, 0)

    def eof(self, frame_no: int) -> bool:
        return self._ended

    def close(self) -> None:
        if hasattr(self._cur, "close"):
            self._cur.close()
