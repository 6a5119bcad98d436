"""Continuous batched decoding for the serving fleet.

The pre-decode fleet dropped every request the moment its KV context was
assembled ("first-token-only" accounting): goodput counted a response as
done at TTFT and the decode tail never touched the device. This module
models the decode phase as a **per-device continuous batch**:

  - after a request's context is assembled, its engine session yields
    :class:`repro.core.engine.DecodeStart` and the cluster enrols it in
    the device's :class:`DecodeBatcher`;
  - the batcher runs **dispatches** — batched decode steps over the
    co-resident sequences (one token per member per step, step cost from
    :func:`repro.core.engine.decode_step_seconds`: KV reads sum over the
    batch, weight reads amortize once per step);
  - membership changes only at token boundaries (continuous batching):
    joiners wait for the in-flight dispatch to retire, members leave the
    moment their token quota completes, capacity is ``max_batch``;
  - each dispatch is one *job* on the device: in run-queue mode the
    cluster submits it to the :class:`repro.serving.resources.
    DeviceRunQueue`, so decode steps genuinely contend with in-flight
    prefill chunks under the FIFO/WFQ/SRPT discipline (the
    ``tokens_per_dispatch`` knob trades decode/prefill interleaving
    granularity against per-job overhead — 1 yields the device to
    queued prefill work at every token boundary).

The batcher is deterministic and clock-free: it *plans* dispatches
(durations + per-member token offsets relative to service start) and the
cluster owns actual start times (immediate or queued).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.core.engine import decode_step_seconds


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Continuous-batching knobs for the per-device decode batch.

    Parameters
    ----------
    max_batch : co-resident sequences per device batch; joiners beyond it
        wait at token boundaries for a slot.
    tokens_per_dispatch : tokens generated per run-queue job (the
        chunked-prefill interleave knob): 1 = finest interleave with
        queued prefill chunks, larger values let decode hold the device
        for several token steps per dispatch.
    weight : WFQ weight of the device's decode flow when dispatches run
        through a weighted run queue.
    """
    max_batch: int = 8
    tokens_per_dispatch: int = 1
    weight: float = 1.0

    def __post_init__(self):
        assert self.max_batch >= 1, self.max_batch
        assert self.tokens_per_dispatch >= 1, self.tokens_per_dispatch
        assert self.weight > 0, self.weight


@dataclasses.dataclass
class _Member:
    rid: int
    context_len: int                  # KV length the next token reads
    remaining: int                    # tokens still owed
    deadline_s: Optional[float] = None   # absolute TTFT deadline (EDF floor)


@dataclasses.dataclass
class Dispatch:
    """One planned batched-decode job: ``duration_s`` of device service
    delivering ``token_offsets[rid]`` (offsets from service start) to each
    member. ``finished`` lists members whose quota completes with this
    dispatch; ``busy_share`` splits the device-busy time across the
    co-resident members for per-request energy accounting."""
    seq: int
    duration_s: float
    token_offsets: dict               # rid -> tuple[float, ...]
    busy_share: dict                  # rid -> seconds
    finished: tuple                   # rids leaving at this boundary
    batch_size: int


class DecodeBatcher:
    """Per-device continuous decode batch (see module docstring).

    Protocol with the cluster::

        enroll(rid, context_len, n_tokens)     # DecodeStart arrived
        d = next_dispatch()                    # plan a job (or None)
        ... cluster serves d.duration_s on the device ...
        d = dispatch_done()                    # retire, promote joiners

    ``next_dispatch`` commits the planned tokens to member state, so
    exactly one dispatch is in flight per device at a time.
    """

    def __init__(self, cfg_model, profile, dcfg: DecodeConfig):
        self.cfg = cfg_model
        self.profile = profile
        self.dcfg = dcfg
        self.active: dict[int, _Member] = {}
        self.waiting: deque[_Member] = deque()
        self.inflight: Optional[Dispatch] = None
        # rids whose KV was evicted by the memory server: they keep their
        # batch slot (continuous-batching membership is the contract) but
        # are excluded from dispatches until the cluster resumes them
        # after the reload lands
        self.suspended: set = set()
        self._seq = 0
        self.tokens_dispatched = 0
        self.busy_s = 0.0

    # ---- telemetry ----
    def occupancy(self) -> int:
        """Sequences decoding or waiting to join (admission telemetry:
        the batch size a newcomer should expect to share a step with)."""
        return len(self.active) + len(self.waiting)

    def idle(self) -> bool:
        return self.inflight is None and not self.active and not self.waiting

    def remaining_service_s(self) -> float:
        """Estimated decode service left on this device (drives the run
        queue's SRPT ordering): steps to drain the longest member at the
        current batch composition's step cost."""
        members = [*self.active.values(), *self.waiting]
        if not members:
            return 0.0
        steps_left = max(m.remaining for m in members)
        lens = [m.context_len for m in members[:self.dcfg.max_batch]]
        return steps_left * decode_step_seconds(self.cfg, lens or [1],
                                                self.profile)

    def min_deadline(self) -> Optional[float]:
        """Earliest member deadline (arms the SRPT queue's EDF floor for
        the decode flow)."""
        ds = [m.deadline_s for m in self.active.values()
              if m.deadline_s is not None]
        return min(ds) if ds else None

    # ---- KV eviction protocol (memory server) ----
    def suspend(self, rid: int) -> None:
        """Exclude an enrolled member from future dispatches (its KV was
        demoted/dropped); it keeps its batch slot until resumed."""
        self.suspended.add(rid)

    def resume(self, rid: int) -> None:
        """Reload landed: the member decodes again from the next
        dispatch boundary."""
        self.suspended.discard(rid)

    def suspended_active(self) -> list[int]:
        """Suspended members currently holding a batch slot — the rids
        whose KV must be reloaded for the batch to make progress (the
        cluster starts a reload for each before planning a dispatch)."""
        return sorted(r for r in self.active if r in self.suspended)

    # ---- protocol ----
    def enroll(self, rid: int, context_len: int, n_tokens: int, *,
               deadline_s: Optional[float] = None) -> None:
        assert n_tokens >= 1, n_tokens
        assert rid not in self.active, f"rid {rid} already decoding"
        m = _Member(rid=rid, context_len=context_len, remaining=n_tokens,
                    deadline_s=deadline_s)
        if self.inflight is None and len(self.active) < self.dcfg.max_batch:
            self.active[rid] = m
        else:
            # token-boundary join: wait for the in-flight dispatch (or a
            # free batch slot) — continuous batching, not stop-the-world
            self.waiting.append(m)

    def next_dispatch(self) -> Optional[Dispatch]:
        """Plan the next batched job; None when a dispatch is already in
        flight or nothing is decoding. Token counts/lengths are committed
        here (membership is frozen for the dispatch)."""
        if self.inflight is not None or not self.active:
            return None
        live = [self.active[r] for r in sorted(self.active)
                if r not in self.suspended]
        if not live:
            return None               # every slot-holder awaits a reload
        offs: dict[int, list] = {m.rid: [] for m in live}
        busy = {m.rid: 0.0 for m in live}
        t = 0.0
        for _ in range(self.dcfg.tokens_per_dispatch):
            if not live:
                break
            lens = [m.context_len for m in live]
            dt = decode_step_seconds(self.cfg, lens, self.profile)
            t += dt
            share = dt / len(live)
            for m in live:
                offs[m.rid].append(t)
                busy[m.rid] += share
                m.context_len += 1
                m.remaining -= 1
                self.tokens_dispatched += 1
            live = [m for m in live if m.remaining > 0]
        d = Dispatch(seq=self._seq, duration_s=t,
                     token_offsets={r: tuple(v) for r, v in offs.items()},
                     busy_share=busy,
                     # offs iterates in rid order (live is rid-sorted)
                     finished=tuple(r for r in offs
                                    if self.active[r].remaining == 0),
                     batch_size=len(offs))
        self._seq += 1
        self.busy_s += t
        self.inflight = d
        return d

    def dispatch_done(self) -> Dispatch:
        """Retire the in-flight dispatch at its completion boundary: drop
        finished members, promote waiting joiners into free batch slots,
        and return the dispatch for token delivery."""
        d = self.inflight
        assert d is not None, "no dispatch in flight"
        self.inflight = None
        for rid in d.finished:
            del self.active[rid]
        while self.waiting and len(self.active) < self.dcfg.max_batch:
            m = self.waiting.popleft()
            self.active[m.rid] = m
        return d
