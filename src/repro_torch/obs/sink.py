"""Host-side metric sinks (torch port of ``repro.obs.sink``).

A sink receives one plain-``dict`` record per emitted metric event (the
JSONL schema documented in ``repro_torch.obs``) and must be cheap: the
registry hands it records already normalised and summarised, so sinks
only append and buffer.

* :class:`ListSink` -- in memory, for tests and ``obs.capture()``.
* :class:`JsonlSink` -- append-only ``metrics.jsonl`` under a directory,
  buffered, flushed explicitly (``obs.flush()``; the launchers flush once
  a step) and on close.

Both accumulate ``counter``-kind events into ``totals`` so callers can
read running counts without replaying the event stream.  The records and
their serialisation are the reference's, byte for byte except ``ts``, so
one set of tooling reads the files of both packages.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict

__all__ = ["Sink", "ListSink", "JsonlSink"]


class Sink:
    """Interface: ``write(record: dict)``, ``flush()``, ``close()``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def _accumulate(self, record: dict) -> None:
        if record.get("kind") == "counter":
            v = record.get("value", 0)
            try:
                self.totals[record["metric"]] += float(v)
            except TypeError:  # vector counter: sum the components
                self.totals[record["metric"]] += float(sum(v))

    def write(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class ListSink(Sink):
    """Collect records in memory (``obs.capture()`` hands out ``records``)."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        with self._lock:
            self.records.append(record)
            self._accumulate(record)


class JsonlSink(Sink):
    """Append JSON lines to ``<directory>/metrics.jsonl``.

    Writes are buffered in memory and serialised under a lock;
    ``flush()`` drains the buffer to disk so a crashed run keeps
    everything up to its last completed step.
    """

    def __init__(self, directory: str, filename: str = "metrics.jsonl"):
        super().__init__()
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._buf: list[str] = []
        self._fh = open(self.path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"), default=_jsonify)
        with self._lock:
            self._buf.append(line)
            self._accumulate(record)

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
            if buf and not self._fh.closed:
                self._fh.write("\n".join(buf) + "\n")
                self._fh.flush()

    def close(self) -> None:
        self.flush()
        if not self._fh.closed:
            self._fh.close()


def _jsonify(obj):
    """Fallback serialiser for numpy scalars that escape normalisation."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)
