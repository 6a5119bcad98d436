"""The program's spans: host time by name, and ranges in the profiler.

``with span(name): ...`` adds the block's host seconds
(``time.perf_counter``) to the innermost open sink, a ``dict[str, float]``
that an enclosing ``span(..., into=sink)`` opened; ``into=`` pushes its
dict as the sink for the span's extent and adds the span's own time to it.
``sync=device`` first waits for the device's queued work, so that the time
is the work's own. Where no sink is open a span does nothing (no clock, no
profiler range): model code that training, tests or examples call outside
a server records nothing.

While a ``torch.profiler`` records, each span that records also opens
``torch.profiler.record_function("repro_torch." + name)``, so that it lies
on the device trace's clock, nested as the spans are, with its device work
under it as a GPU user annotation. With no profiler recording,
``record_function`` is never entered.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

from repro_torch.device import sync as _sync

PREFIX = "repro_torch."

_sinks: list[dict] = []      # the open sinks, innermost last


class span:
    """A named span; see the module docstring. A span is entered once."""

    __slots__ = ("name", "into", "sync", "_sink", "_range", "_t0")

    def __init__(self, name: str, *, into: dict | None = None, sync=None):
        self.name, self.into, self.sync = name, into, sync

    def __enter__(self):
        if self.into is not None:
            _sinks.append(self.into)
        elif not _sinks:
            self._sink = None
            return self
        self._sink = _sinks[-1]
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sink = self._sink
        if sink is None:
            return False
        try:
            if self.sync is not None:
                _sync(self.sync)
            sink[self.name] = (sink.get(self.name, 0.0)
                               + time.perf_counter() - self._t0)
        finally:
            if self._range is not None:
                self._range.__exit__(*exc)
            if self.into is not None:
                _sinks.pop()
        return False
