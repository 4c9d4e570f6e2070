"""Streaming model loader: background PLY parse feeding budgeted uploads.

Parity with reference:
- `GaussianSplattingModel::init_load` (`src/app.rs:1048-1096`): read header ->
  count known up front; background task streams splats over a channel.
- Budgeted drain: the scene drains up to 1000 splats per batch within a
  ~0.06 s frame budget and uploads each batch to the device
  (`src/tab/scene.rs:340-380`).

Host-side threading is the equivalent of the reference's task spawn
(`src/util.rs:3-13`): a daemon thread parses chunks into a bounded queue; the
frame loop drains within a time budget and pushes donated device updates.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import BinaryIO, Callable, Optional

from ..data.gaussian import Gaussians
from ..data.ply import PlyReadStats, read_ply_chunks, read_ply_header
from ..utils.log import get_logger
from ..utils.tasks import exec_task

_log = get_logger("loader")

# Reference pacing (src/tab/scene.rs:358-364).
DRAIN_BATCH = 1000
DRAIN_BUDGET_S = 0.06


class StreamingLoader:
    """Streams a PLY into per-chunk `Gaussians`, header-first."""

    def __init__(self, reader: BinaryIO, chunk_size: int = DRAIN_BATCH):
        self.header = read_ply_header(reader)  # raises PlyError on bad input
        self.count = self.header.count
        self.received = 0
        self.error: Optional[str] = None
        # Malformed records are skipped and counted, not fatal
        # (ref `src/tab/scene.rs:352-356`): `stats.dropped` is surfaced in
        # the UI state alongside the progress bar.
        self.stats = PlyReadStats()
        self._done = False
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._thread = exec_task(self._run, reader, chunk_size)

    def _run(self, reader, chunk_size):
        _log.debug("stream start: %d declared splats", self.count)
        try:
            for chunk in read_ply_chunks(reader, self.header, chunk_size,
                                         stats=self.stats):
                self._q.put(chunk)
        except Exception as e:  # per-splat errors surfaced, not fatal to the app
            self.error = str(e)
            _log.warning("stream failed: %s", e)
        finally:
            if self.stats.skipped:
                # Ref logs and skips malformed splats (src/tab/scene.rs:352-356).
                _log.warning("skipped %d malformed record(s)", self.stats.skipped)
            _log.debug("stream done: skipped=%d truncated=%d",
                       self.stats.skipped, self.stats.truncated)
            self._q.put(None)

    @property
    def finished(self) -> bool:
        return self._done or self.error is not None

    def drain(self, budget_s: float = DRAIN_BUDGET_S, on_chunk: Optional[Callable] = None):
        """Drain available chunks within the time budget.

        Calls `on_chunk(start_index, gaussians)` per chunk (the device upload
        hook). Returns the number of splats drained this call.
        """
        t0 = time.monotonic()
        drained = 0
        while time.monotonic() - t0 < budget_s:
            try:
                chunk = self._q.get_nowait()
            except queue.Empty:
                break
            if chunk is None:
                self._done = True
                break
            if on_chunk is not None:
                on_chunk(self.received, chunk)
            self.received += chunk.count
            drained += chunk.count
        return drained

    def progress(self) -> float:
        return self.received / max(self.count, 1)


class Loadable:
    """Unloaded-or-loaded slot with error surfacing.

    Mirror of `Loadable<T, E>` (`src/app.rs:420-467`): the loading path posts
    either the value or an error string; `error` renders in the UI drop
    target (`src/tab/scene.rs:214-217`).
    """

    def __init__(self):
        self.value = None
        self.error: Optional[str] = None
        self._lock = threading.Lock()

    @property
    def is_loaded(self) -> bool:
        return self.value is not None

    def post(self, value=None, error: Optional[str] = None):
        with self._lock:
            if error is not None:
                self.error = error
            else:
                self.value = value
                self.error = None
