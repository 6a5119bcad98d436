"""Typed event core for the cluster's discrete-event loop.

``ServingCluster.run`` used to drive a bare ``heapq`` of
``(t, seq, kind_str, rid, payload)`` tuples: every push allocated a
fresh tuple, every dispatch compared interned strings, and the initial
trace load-in heap-pushed one arrival at a time. This module lifts that
inner loop onto three small primitives:

- :class:`EventKind` — an ``IntEnum`` of the cluster's event types, so
  dispatch is an int compare and event records are self-describing;
- :class:`Event`    — a ``NamedTuple`` ``(t, seq, kind, rid, payload)``.
  Ordering is by ``(t, seq)`` (``seq`` is unique per queue, so ``kind``
  / ``payload`` never participate in comparisons), exactly the order
  the bare-tuple heap produced — the event *schedule* of a run is
  bit-identical either way;
- :class:`EventQueue` — the heap. ``push`` is a plain ``heappush``;
  ``push_many`` bulk-loads a batch (the whole arrival trace at run
  start) with ``extend + heapify`` when the batch dominates the heap —
  O(n + k) instead of O(k log n) — and falls back to pushes for small
  batches. ``peek_t`` exposes the head timestamp without popping, which
  is all the main loop needs to arbitrate against the link server's
  ``next_completion``.

The module also keeps the process-wide :data:`STATS` accumulator:
every ``ServingCluster.run`` records its event count and wall-clock
here (and in ``cluster.last_sim_stats``), and ``benchmarks/run.py
--profile`` drains it into each bench's JSON — simulator throughput
(events/s) is a first-class, regression-guarded metric like any other
benchmark number.
"""
from __future__ import annotations

import dataclasses
import heapq
from enum import IntEnum
from typing import Iterable, NamedTuple, Optional


class EventKind(IntEnum):
    """Cluster event types (values are stable; telemetry may store them)."""
    ARRIVAL = 0
    COMPUTE_DONE = 1
    DECODE_DONE = 2
    STREAM_AVAIL = 3
    RELOAD_STREAM_DONE = 4
    RELOAD_DISK_DONE = 5
    RELOAD_COMPUTE_DONE = 6
    # hostile-world scenario events (serving/scenarios.py); only pushed
    # when a ScenarioTrace is armed — static fleets never see them
    HANDOFF = 7
    CHURN = 8
    OUTAGE_START = 9
    OUTAGE_END = 10


class Event(NamedTuple):
    """One scheduled event. Heap order is ``(t, seq)``; ``seq`` is
    unique within a queue so comparisons never reach ``kind``/``payload``
    (payloads need not be orderable)."""
    t: float
    seq: int
    kind: int
    rid: int
    payload: object = None


class EventQueue:
    """Min-heap of :class:`Event` records with batched insertion."""

    __slots__ = ("_heap", "_seq", "n_pushed", "n_popped")

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = 0
        self.n_pushed = 0
        self.n_popped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, t: float, kind: int, rid: int, payload=None) -> Event:
        ev = Event(t, self._seq, int(kind), rid, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        self.n_pushed += 1
        return ev

    def push_many(self, records: Iterable[tuple]) -> list[Event]:
        """Schedule a batch of ``(t, kind, rid, payload)`` records.
        Sequence numbers follow iteration order (ties pop in the order
        given, matching k sequential pushes). When the batch dominates
        the current heap — the run-start arrival load-in — the heap is
        rebuilt in one O(n + k) heapify instead of k O(log n) pushes;
        either way the pop order is identical (total order by (t, seq))."""
        evs = [Event(t, self._seq + i, int(kind), rid, payload)
               for i, (t, kind, rid, payload) in enumerate(records)]
        self._seq += len(evs)
        self.n_pushed += len(evs)
        if len(evs) > max(8, len(self._heap)):
            self._heap.extend(evs)
            heapq.heapify(self._heap)
        else:
            for ev in evs:
                heapq.heappush(self._heap, ev)
        return evs

    def peek_t(self) -> float:
        """Timestamp of the earliest event (+inf when empty) — the main
        loop's arbitration bound against the link server's completion."""
        return self._heap[0].t if self._heap else float("inf")

    def pop(self) -> Event:
        self.n_popped += 1
        return heapq.heappop(self._heap)


# ---------------------------------------------------------------------------
# Simulator-throughput accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimStats:
    """Cumulative simulator-throughput counters (events processed and
    wall-clock spent inside ``ServingCluster.run`` loops). A process-wide
    instance lives at :data:`STATS`; ``benchmarks/common.save`` snapshots
    and resets it per bench under ``--profile``."""
    n_events: int = 0
    wall_s: float = 0.0
    n_runs: int = 0

    def record(self, n_events: int, wall_s: float) -> None:
        self.n_events += int(n_events)
        self.wall_s += float(wall_s)
        self.n_runs += 1

    def events_per_s(self) -> Optional[float]:
        return self.n_events / self.wall_s if self.wall_s > 0 else None

    def reset(self) -> None:
        self.n_events = 0
        self.wall_s = 0.0
        self.n_runs = 0

    def snapshot(self) -> dict:
        return {"sim_events": self.n_events,
                "sim_wall_s": self.wall_s,
                "sim_runs": self.n_runs,
                "sim_events_per_s": self.events_per_s()}


STATS = SimStats()
