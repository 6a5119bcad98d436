"""Runtime adaptation mechanism (paper §IV-D).

Sliding-window monitors of achieved bandwidth and compute speed drive
bounded chunk migrations between the streaming and computation paths:

  - wireless bandwidth drop  -> stream path is the transient bottleneck:
    compute-ready chunks still queued for streaming are executed locally
    (head of stream queue by compute-priority), plus speculative advance
    into later-stage compute-ready chunks when the GPU idles.
  - edge compute contention  -> compute path is the bottleneck: chunks are
    migrated from the *tail* of the compute order to streaming (tail-first
    minimizes disturbance to imminent work).

Compute contention is observed through two channels: service-time dilation
(actual/predicted per chunk — the scalar-util world) and, when the cluster
runs an explicit device run queue, *queueing delay* (wait/service per
chunk, fed by the engine via ``record_queue_wait``). Queue pressure
inflates the compute-path backlog estimate the same way slowdown does, so
migration decisions respond to waiting work even when service times are
undilated.

Migrations per stage are bounded (spcfg.max_migrations_per_stage) to avoid
oscillation.

Deadline awareness (SLO layer): the serving cluster stamps a request's
absolute TTFT deadline onto its controller (``set_deadline``). When the
remaining slack falls inside the guard window *and* the measured link
bandwidth has degraded below ``congested_frac`` of the planned bandwidth,
compute->stream migrations are suppressed — a near-deadline flow is never
migrated onto a congested link, where the queued bytes would land behind
everyone else's backlog with no time left to recover.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.chunks import Chunk


@dataclasses.dataclass
class Migration:
    chunk: Chunk
    to_path: str          # "stream" | "compute"
    reason: str


@dataclasses.dataclass
class WindowStat:
    window_s: float
    samples: deque = dataclasses.field(default_factory=deque)

    def add(self, t: float, value: float):
        self.samples.append((t, value))
        self.trim(t)

    def trim(self, now: float):
        while self.samples and self.samples[0][0] < now - self.window_s:
            self.samples.popleft()

    def rate(self, now: float) -> Optional[float]:
        """Sum of values in window / window length."""
        self.trim(now)
        if not self.samples:
            return None
        return sum(v for _, v in self.samples) / self.window_s

    def mean_ratio(self, now: float) -> Optional[float]:
        self.trim(now)
        if not self.samples:
            return None
        return float(np.mean([v for _, v in self.samples]))


class RuntimeController:
    def __init__(self, spcfg, plan_bw: float):
        self.cfg = spcfg
        self.plan_bw = plan_bw
        self.bw_win = WindowStat(spcfg.window_s)         # bytes delivered
        self.comp_win = WindowStat(spcfg.window_s)       # actual/predicted
        self.queue_win = WindowStat(spcfg.window_s)      # wait/service
        self.migrations_this_stage = 0
        self.n_migrations = 0
        self.n_losses = 0             # aborted transfers observed (mobility)
        self.bytes_lost = 0.0         # wasted wire bytes across those aborts
        self._last_reset = 0.0
        # SLO deadline (absolute, on the driver's clock); None = no SLO
        self.deadline_s: Optional[float] = None
        self.slack_guard_s = 2.0
        self.congested_frac = 0.6
        # content-key store hits: the third leg beside stream/compute —
        # these chunks ride the cheap cached-egress path, not the
        # congested origin link (empty = pre-reuse behaviour, exactly)
        self.store_hits: frozenset = frozenset()

    def record_stream(self, t: float, nbytes: float):
        self.bw_win.add(t, nbytes)

    def record_compute(self, t: float, actual_s: float, predicted_s: float):
        self.comp_win.add(t, actual_s / max(predicted_s, 1e-9))

    def record_queue_wait(self, t: float, wait_s: float, service_s: float):
        """Device run-queue wait observed for one compute chunk (engine
        calls this when the driver acknowledged a queued start)."""
        self.queue_win.add(t, wait_s / max(service_s, 1e-9))

    def note_loss(self, t: float, *, nbytes_lost: float = 0.0):
        """An in-flight transfer was aborted (handoff re-route, AP
        outage): record a zero-delivery bandwidth sample so the measured
        link rate reflects the wasted wire time — repeated losses drag
        ``measured_bw`` down and create migration pressure toward local
        compute at the very boundary where the lost chunk re-enters the
        backlog."""
        self.bw_win.add(t, 0.0)
        self.n_losses += 1
        self.bytes_lost += float(nbytes_lost)

    def set_deadline(self, t_deadline_s: float, *,
                     slack_guard_s: Optional[float] = None,
                     congested_frac: Optional[float] = None):
        """Arm the deadline guard: an absolute TTFT deadline on the
        driver's clock, the slack window inside which migrations onto a
        degraded link are suppressed, and the measured/planned bandwidth
        ratio below which the link counts as congested (None keeps the
        controller's current values)."""
        self.deadline_s = t_deadline_s
        if slack_guard_s is not None:
            self.slack_guard_s = slack_guard_s
        if congested_frac is not None:
            self.congested_frac = congested_frac

    def set_store_hits(self, chunks) -> None:
        """Arm the store-hit leg: `chunks` are content-key hits served
        from the cloud KV store's edge replica. The controller treats
        them as a third path — their bytes do not load the origin stream
        backlog, and a bandwidth drop never migrates them to compute (a
        cache read is not the congested link)."""
        self.store_hits = frozenset(chunks)

    def _deadline_blocks_stream(self, now: float, bw: float) -> bool:
        """True when this flow is near its deadline and the link is
        congested — to-stream migrations would strand imminent work."""
        if self.deadline_s is None:
            return False
        return (self.deadline_s - now <= self.slack_guard_s
                and bw < self.congested_frac * self.plan_bw)

    def new_stage(self):
        self.migrations_this_stage = 0

    def measured_bw(self, now: float) -> float:
        r = self.bw_win.rate(now)
        return r if r and r > 0 else self.plan_bw

    def compute_slowdown(self, now: float) -> float:
        r = self.comp_win.mean_ratio(now)
        return r if r else 1.0

    def queue_pressure(self, now: float) -> float:
        """Mean wait/service ratio in the window; 0 when the device queue
        is idle (or the driver has no explicit queue)."""
        r = self.queue_win.mean_ratio(now)
        return r if r else 0.0

    def decide(self, now: float, *, stream_queue, comp_queue,
               ready, chunk_bytes, t_comp_pred) -> list[Migration]:
        """Called at event boundaries. Queues are lists of Chunks (stream
        order / compute order); `ready` is the currently compute-ready set.
        Returns bounded migrations."""
        cfg = self.cfg
        # windowed migration budget (paper: bounded per stage to avoid
        # oscillation; the engine has no stage clock, so budgets reset per
        # monitor window)
        if now - self._last_reset >= cfg.window_s:
            self.migrations_this_stage = 0
            self._last_reset = now
        if self.migrations_this_stage >= cfg.max_migrations_per_stage:
            return []
        bw = self.measured_bw(now)
        # queueing delay and service dilation both stretch the compute
        # path; a chunk that waits w and runs s effectively costs s*(1+w/s)
        slow = self.compute_slowdown(now) * (1.0 + self.queue_pressure(now))
        # store-hit chunks ride the cached-egress leg, not the measured
        # origin link: they neither load the stream backlog nor are
        # candidates to pull local when the origin bandwidth drops
        t_s = sum(chunk_bytes[c] for c in stream_queue
                  if c not in self.store_hits) / bw \
            if stream_queue else 0.0
        t_c = sum(t_comp_pred[c] for c in comp_queue) * slow \
            if comp_queue else 0.0

        out: list[Migration] = []
        budget = cfg.max_migrations_per_stage - self.migrations_this_stage
        if t_s > cfg.imbalance_threshold * max(t_c, 1e-9) and stream_queue:
            # network is the bottleneck: pull compute-ready streamed chunks
            # to the local path (cheapest-compute first), enough to
            # restore balance
            cands = [c for c in stream_queue if c in ready
                     and c not in self.store_hits]
            cands.sort(key=lambda c: t_comp_pred[c])
            moved_s = 0.0
            for c in cands[:budget]:
                if t_s - moved_s <= t_c + moved_s:
                    break
                out.append(Migration(c, "compute", "bandwidth_drop"))
                moved_s += chunk_bytes[c] / bw
        elif t_c > cfg.imbalance_threshold * max(t_s, 1e-9) and comp_queue \
                and not self._deadline_blocks_stream(now, bw):
            # compute is the bottleneck: shed the tail of the compute order
            moved_c = 0.0
            for c in list(reversed(comp_queue))[:budget]:
                if t_c - moved_c <= t_s + moved_c:
                    break
                out.append(Migration(c, "stream", "compute_contention"))
                moved_c += t_comp_pred[c] * slow
        self.migrations_this_stage += len(out)
        self.n_migrations += len(out)
        return out
