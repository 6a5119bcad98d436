"""Discrete-event hybrid execution engine.

Executes a Schedule on a virtual clock with two serial servers:
  - network: consumes a time-varying bandwidth trace (real compressed chunk
    bytes), + per-chunk t_proc (entropy decode + dequant);
  - device: ground-truth block-sparse-attention latencies (nonlinear, load-
    and noise-dependent — the thing the predictor approximates).

The engine is work-conserving: within the scheduled priority order the
compute server starts the first dependency-ready chunk. The runtime
controller (§IV-D) may migrate queued chunks between paths at event
boundaries. TTFT = context completion + first-token decode.

Two driving modes:

  - ``run(schedule)`` — the classic closed loop: this request owns the
    whole ``BandwidthIntegrator`` and the device, and the engine advances
    its own clock (single-request semantics, unchanged). Semantically it
    is a capacity-1 device with an always-idle run queue.
  - ``session(schedule)`` — an event-yielding coroutine stepped by an
    *external* clock (``repro.serving.cluster.ServingCluster``). The
    protocol, per yield:

      * :class:`StreamStart`  — engine asks for a network transfer; the
        driver maps it onto a link server (single arbiter or multi-stage
        :class:`repro.serving.resources.LinkTopology`) and replies None.
      * :class:`ComputeStart` — engine asks for device service. This is a
        *queue-admission* step, not an implied immediate start: the driver
        replies with a :class:`StartAck` whose ``t_start`` is the service
        start time, or ``StartAck(None)`` when the job went into an
        explicit device run queue (``repro.serving.resources.
        DeviceRunQueue``) and will start later. A plain ``None`` reply is
        the legacy immediate-start shorthand (what ``run()`` sends).
      * :class:`Wait` — engine has nothing more to start; the driver must
        resume the generator with this request's next :class:`Completion`
        (whose ``t_start`` is the actual service start, so queue wait is
        observable as ``t_start - submit time``).
      * :class:`DecodeStart` — with ``max_new_tokens > 0`` the engine,
        once its context is assembled, asks for autoregressive decode.
        The driver enrols it in a per-device continuous decode batch
        (``repro.serving.decode.DecodeBatcher``) and delivers tokens as
        :class:`DecodeTick` / :class:`DecodeDone` completions at later
        ``Wait`` yields; TTFT/TTLT/TPOT then come from the batcher's
        token timeline instead of the analytic first-token constant.
        With ``max_new_tokens == 0`` (the default) the decode phase is
        absent and results are bit-identical to pre-decode behaviour.

    Controller bookkeeping follows the ack: an immediate start records the
    compute sample at yield time (bit-compatible with PR 1); a queued
    start defers the record to the completion, stamped with the *actual*
    service interval, and additionally feeds the controller's queue-wait
    telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.chunks import Chunk, ChunkGrid, State
from repro_torch.core.controller import RuntimeController
from repro_torch.core.costs import (DeviceProfile, EnergyMeter,
                              GroundTruthLatency, KVStoreModel,
                              t_store_miss_encode)
from repro_torch.core.scheduler import Schedule


class LinkStarvedError(RuntimeError):
    """The bandwidth trace (including its tail extrapolation) cannot
    deliver the requested bytes within ``max_horizon_s`` of the start
    time. Raised by :meth:`BandwidthIntegrator.finish_time` instead of
    silently returning a completion time earlier than the actual
    delivery (the pre-fix behaviour when the trace flatlines at ~0)."""


@dataclasses.dataclass
class EngineResult:
    ttft_s: float
    context_done_s: float
    energy: dict
    n_streamed: int
    n_computed: int
    n_migrations: int
    stream_busy_s: float
    compute_busy_s: float
    proc_busy_s: float
    timeline: list            # (t_start, t_end, path, chunk)
    streamed_set: set
    computed_set: set
    bytes_streamed: float
    compute_wait_s: float = 0.0   # total device run-queue wait observed
    n_compute_queued: int = 0     # compute chunks that did not start at once
    # decode phase (max_new_tokens > 0; defaults are the first-token-only
    # accounting: one token, delivered at ttft_s)
    n_tokens_out: int = 1
    ttlt_s: float = 0.0           # last-token time (driver clock)
    tpot_s: float = 0.0           # mean inter-token time after the first
    decode_busy_s: float = 0.0    # this request's share of decode-step time
    token_times: tuple = ()       # absolute per-token delivery times
    # cross-request KV reuse (zeros without a reuse layer — defaults keep
    # pre-reuse results bit-identical)
    n_reused: int = 0             # chunks satisfied by the device prefix cache
    n_store_hits: int = 0         # chunks streamed as cloud-store hits
    bytes_hit_stream: float = 0.0  # streamed bytes that rode the hit leg
    # hostile-world mobility (zeros without scenario events — defaults
    # keep static fleets bit-identical)
    n_lost: int = 0               # in-flight transfers aborted (handoff/outage)
    bytes_lost: float = 0.0       # partially delivered bytes wasted by aborts
    bytes_restreamed: float = 0.0  # bytes re-issued for previously-lost chunks

    def breakdown(self) -> dict:
        return {
            "transmission_s": self.stream_busy_s - self.proc_busy_s,
            "decode_proc_s": self.proc_busy_s,
            "compute_s": self.compute_busy_s,
            "queue_wait_s": self.compute_wait_s,
            "ttft_s": self.ttft_s,
        }


class BandwidthIntegrator:
    """Cumulative-bytes view over a bandwidth trace."""

    def __init__(self, trace: np.ndarray, dt: float):
        self.dt = dt
        self.cum = np.concatenate([[0.0], np.cumsum(trace) * dt])
        self._grid: Optional[np.ndarray] = None   # lazy (at_many only)

    def bytes_between(self, t0: float, t1: float) -> float:
        return self._at(t1) - self._at(t0)

    @property
    def tail_bw(self) -> float:
        """Constant extrapolation rate beyond the trace end (mean of the
        trace tail)."""
        return (self.cum[-1] - self.cum[max(len(self.cum) - 100, 0)]) \
            / (self.dt * min(99, len(self.cum) - 1))

    @property
    def grid_end_s(self) -> float:
        """Last instant covered by the trace itself (extrapolated after)."""
        return (len(self.cum) - 1) * self.dt

    def at_many(self, t: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`_at`: cumulative bytes at each time in `t`,
        with the same piecewise-linear interpolation and tail
        extrapolation (multi-stage link topologies integrate over many
        cell boundaries at once)."""
        if self._grid is None:
            self._grid = np.arange(len(self.cum)) * self.dt
        out = np.interp(t, self._grid, self.cum)
        over = t > self._grid[-1]
        if np.any(over):
            out = np.where(over,
                           self.cum[-1] + (t - self._grid[-1]) * self.tail_bw,
                           out)
        return out

    def _at(self, t: float) -> float:
        i = t / self.dt
        i0 = int(np.floor(i))
        if i0 >= len(self.cum) - 1:
            # extrapolate with the mean of the tail
            return self.cum[-1] + (t - self.grid_end_s) * self.tail_bw
        return self.cum[i0] + (i - i0) * (self.cum[i0 + 1] - self.cum[i0])

    def finish_time(self, t0: float, nbytes: float, *,
                    max_horizon_s: float = 1e5) -> float:
        """Earliest t where nbytes are delivered starting at t0.

        Raises :class:`LinkStarvedError` when the trace cannot deliver
        the bytes within ``max_horizon_s`` seconds of ``t0`` (starved /
        flatlined link) rather than returning an undershooting time.
        """
        if nbytes <= 0:
            return t0
        target = self._at(t0) + nbytes
        lo, hi = t0, t0 + 1e-3
        while self._at(hi) < target:
            hi = t0 + (hi - t0) * 2
            if hi - t0 > max_horizon_s:
                break
        if self._at(hi) < target:
            raise LinkStarvedError(
                f"link starved: {nbytes:.0f} B not deliverable within "
                f"{max_horizon_s:.0f}s of t={t0:.3f} "
                f"(delivered {self._at(hi) - self._at(t0):.0f} B)")
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if self._at(mid) < target:
                lo = mid
            else:
                hi = mid
        return hi


def _kv_bytes_per_token(cfg, context_len: int) -> float:
    """Per-layer bytes one decode step reads for one sequence: the KV
    cache at `context_len` (bf16 k+v) for attention models, the SSM
    state for state-space models."""
    if cfg.num_heads:
        return 2 * context_len * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    return 2 * cfg.ssm.state_dim * cfg.d_model * cfg.ssm.expand


def context_kv_bytes(cfg, context_len: int) -> float:
    """Device-resident bytes of one request's fully assembled KV context
    at bf16 (all layers): what the serving layer's KV memory server
    charges a request once its prefill completes. SSM models hold a
    fixed-size state per layer instead of a growing cache."""
    return cfg.num_layers * _kv_bytes_per_token(cfg, context_len)


def token_kv_bytes(cfg) -> float:
    """Resident-KV growth of one decoded token (all layers, bf16): the
    per-``DecodeTick`` charge on the KV memory server. Zero for SSM
    models — their state does not grow with decoded tokens."""
    if not cfg.num_heads:
        return 0.0
    return cfg.num_layers * _kv_bytes_per_token(cfg, 1)


def decode_first_token_seconds(cfg, context_len: int,
                               profile: DeviceProfile) -> float:
    """One-token forward over the assembled cache (memory-bound)."""
    kv_bytes = _kv_bytes_per_token(cfg, context_len)
    act = cfg.active_param_count()
    per_layer = (kv_bytes / profile.hbm_bw
                 + 2 * (act / max(cfg.num_layers, 1)) / profile.peak_flops)
    return cfg.num_layers * per_layer + 2 * act * 2 / profile.hbm_bw \
        / max(cfg.num_layers, 1)


def decode_step_seconds(cfg, context_lens, profile: DeviceProfile) -> float:
    """One batched decode step: one token for each of ``len(context_lens)``
    co-resident sequences.

    The batched generalization of :func:`decode_first_token_seconds`
    (identical roofline terms, so a batch of one reproduces the
    first-token cost): per-sequence KV reads sum over the batch, compute
    scales with the batch, but the weight-read term is paid **once per
    step** — the amortization that makes continuous batching raise
    tokens/s without changing any per-sequence work."""
    b = len(context_lens)
    assert b >= 1, "decode step needs at least one sequence"
    act = cfg.active_param_count()
    kv_total = sum(_kv_bytes_per_token(cfg, context_len)
                   for context_len in context_lens)
    return (cfg.num_layers * kv_total / profile.hbm_bw
            + b * 2 * act / profile.peak_flops
            + 2 * act * 2 / profile.hbm_bw / max(cfg.num_layers, 1))


# ---------------------------------------------------------------------------
# Session protocol events (engine <-> external clock)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamStart:
    """Engine requests a network transfer for `chunk` (its net server is
    idle). The driver owns delivery timing; `t_proc` is the on-device
    decode+dequant tail the driver must add after the transfer lands."""
    chunk: Chunk
    nbytes: float
    t_proc: float


@dataclasses.dataclass(frozen=True)
class StoreHit:
    """Engine requests a network transfer for `chunk` whose encoded
    bitstream is cached in the cloud KV store (a content-key hit). Same
    shape as :class:`StreamStart`, but the driver routes the bytes over
    the *cached-egress* leg — the path excluding the shared cloud-egress
    stage (the store's edge replica serves it) — and adds the store's
    ``hit_latency_s`` to the on-device tail. Completion comes back with
    ``path == "stream"``."""
    chunk: Chunk
    nbytes: float
    t_proc: float


@dataclasses.dataclass(frozen=True)
class ComputeStart:
    """Engine requests device service for `chunk`; `duration_s` is the
    ground-truth latency already inflated by the utilization the driver
    supplied via `util_fn` (closed-loop) or the static `util` fallback —
    drivers with an explicit run queue supply util 0 and model contention
    as queueing delay instead. The driver acknowledges with a
    :class:`StartAck` (or None = started now, legacy)."""
    chunk: Chunk
    duration_s: float


@dataclasses.dataclass(frozen=True)
class StartAck:
    """Driver's reply to :class:`ComputeStart`. ``t_start`` is the service
    start time; ``None`` means the job was queued on the device server and
    will start later (the engine learns the actual start from the
    eventual :class:`Completion.t_start`)."""
    t_start: Optional[float]


@dataclasses.dataclass(frozen=True)
class Wait:
    """Engine has nothing more to start; the driver must resume the
    generator with the request's next Completion."""


@dataclasses.dataclass(frozen=True)
class StreamLost:
    """Driver's alternative reply at a ``Wait`` yield: the in-flight
    network transfer for `chunk` was aborted mid-delivery (AP handoff
    re-route, AP outage, device churn). Entropy-coded chunk bitstreams
    are undecodable from a partial prefix, so the ``nbytes_delivered``
    bytes already on the wire are wasted; the engine re-enters the chunk
    at the head of its stream backlog and the next ``StreamStart`` rides
    whatever path the driver now routes (the controller may instead flip
    the chunk to local compute at this boundary — the paper's §IV-D
    runtime refinement applied to a route loss)."""
    chunk: Chunk
    t_s: float                # driver clock at the abort
    nbytes_delivered: float   # bytes delivered (and wasted) before abort


@dataclasses.dataclass(frozen=True)
class Completion:
    path: str                 # "stream" | "compute"
    chunk: Chunk
    t_start: float            # service begin (stream: transfer start)
    t_end: float              # chunk available (stream: incl. t_proc)


@dataclasses.dataclass(frozen=True)
class DecodeStart:
    """Engine's context is fully assembled and it wants ``n_tokens`` of
    autoregressive decode. The driver enrols the request into a per-device
    decode batch (``repro.serving.decode.DecodeBatcher``) and replies
    None; token deliveries arrive as :class:`DecodeTick` /
    :class:`DecodeDone` completions at the engine's subsequent ``Wait``
    yields. ``context_len`` is the KV length the first step reads."""
    context_len: int
    n_tokens: int


@dataclasses.dataclass(frozen=True)
class DecodeTick:
    """One batched-dispatch completion for this request: the dispatch ran
    over ``[t_start, t_end]`` on the device and delivered
    ``token_times`` (absolute clock times, one per generated token).
    ``busy_share_s`` is this request's share of the dispatch's device-busy
    time (step time divided by the co-resident batch at each sub-step) —
    the engine folds it into compute-energy accounting."""
    t_start: float
    t_end: float
    token_times: tuple
    batch_size: int
    busy_share_s: float


@dataclasses.dataclass(frozen=True)
class DecodeDone(DecodeTick):
    """The dispatch that delivers this request's final token (its
    ``token_times`` completes the quota requested via DecodeStart)."""


@dataclasses.dataclass(frozen=True)
class KVReload:
    """A parked session's evicted KV must be restored before its next
    decode dispatch. Emitted by the serving layer's KV memory server on
    behalf of the session (the engine itself stays parked in ``Wait``
    until the reload's legs complete and token deliveries resume — the
    stall lands in TTLT/TPOT through the delayed ``DecodeTick`` s, so no
    engine-side accounting changes). ``nbytes`` is the resident KV to
    restore; ``from_disk`` says whether a demoted copy exists on the
    disk tier (otherwise the KV was dropped and must be restreamed or
    recomputed); ``mode`` is the ``MemoryModel.reload`` policy the
    planner will apply."""
    rid: int
    nbytes: float
    from_disk: bool
    mode: str = "planner"


@dataclasses.dataclass
class HybridEngine:
    grid: ChunkGrid
    chunk_bytes: dict            # Chunk -> compressed bytes
    active_blocks: dict          # Chunk -> ground-truth active blocks
    t_comp_pred: dict            # Chunk -> planner's predicted seconds
    gt: GroundTruthLatency
    profile: DeviceProfile
    bw: BandwidthIntegrator
    cfg_model: object            # ModelConfig (for dense/proj costs)
    util: float = 0.0            # static external contention (Fig. 14)
    controller: Optional[RuntimeController] = None
    seed: int = 0
    max_new_tokens: int = 0      # 0 = first-token-only (legacy behaviour)
    # cross-request KV reuse (all empty/None = pre-reuse behaviour, exactly)
    preloaded: frozenset = frozenset()    # chunks resident before t_start
    store_hits: frozenset = frozenset()   # chunks cached in the cloud store
    store_model: Optional[KVStoreModel] = None

    def _t_comp_actual(self, c: Chunk, rng, util: Optional[float] = None
                       ) -> float:
        if c.l == self.grid.n_l - 1:
            return self.profile.t_proj_s
        u = self.util if util is None else util
        t = self.gt.attn_seconds(self.active_blocks[c], u, rng)
        return t + self.gt.dense_seconds(self.cfg_model) / max(self.grid.n_h, 1)

    # ------------------------------------------------------------------
    # Event-yielding core (steppable by an external clock)
    # ------------------------------------------------------------------
    def session(self, schedule: Schedule, *, context_len: int,
                t_start: float = 0.0,
                util_fn: Optional[Callable[[], float]] = None):
        """Generator form of the execution loop.

        Yields StreamStart / ComputeStart requests (driver replies None)
        and Wait markers (driver replies with this request's next
        Completion). Returns an EngineResult via StopIteration.value;
        times in the result are on the driver's clock (`t_start`-based),
        so `ttft_s`/`context_done_s` are absolute for cluster drivers and
        identical to the classic values when t_start == 0.
        """
        rng = np.random.default_rng(self.seed)
        g = self.grid

        state = np.zeros(g.size, np.int8)
        # prefix-reuse: chunks whose assembled KV is already resident on
        # the device (this session's previous turn, or a co-resident
        # request sharing the prefix). STREAMED — present KV satisfies
        # token deps; hidden states were never materialized, so layer
        # deps stay unmet, exactly the physics of reused KV.
        preloaded = frozenset(self.preloaded)
        store_hits = frozenset(self.store_hits)
        for c in preloaded:
            state[g.index(c)] = State.STREAMED
        stream_q: list[Chunk] = []
        comp_q: list[Chunk] = []
        for st in schedule.stages:
            stream_q.extend(c for c in st.stream if c not in preloaded)
            comp_q.extend(c for c in st.comp if c not in preloaded)

        now = t_start
        net_busy = False
        dev_busy = False
        inflight = 0
        done = len(preloaded)
        n_reused = len(preloaded)
        n_store_hits = 0
        bytes_hit_stream = 0.0
        total = g.size
        timeline = []
        stream_busy = comp_busy = proc_busy = bytes_streamed = 0.0
        streamed_set, computed_set = set(), set()
        n_migr = 0
        compute_wait = 0.0
        n_queued = 0
        submit_t: dict[Chunk, float] = {}     # compute admission times
        deferred: set[Chunk] = set()          # queued: record at completion
        # mobility loss/resume bookkeeping (inert on static fleets)
        n_lost = 0
        bytes_lost = 0.0
        bytes_restreamed = 0.0
        attempted: set[Chunk] = set()         # chunks with a StreamStart issued
        pending_stream = None                 # (chunk, nbytes, t_proc, is_hit)

        def ready_set():
            return {c for c in comp_q if g.compute_ready(c, state)}

        def controller_boundary():
            # controller migrations at an event boundary (completion or
            # route loss) — shared so a loss gets the same §IV-D
            # stream<->compute refinement a completion does
            nonlocal n_migr
            migr = self.controller.decide(
                now, stream_queue=stream_q, comp_queue=comp_q,
                ready=ready_set() | {cc for cc in stream_q
                                     if g.compute_ready(cc, state)},
                chunk_bytes=self.chunk_bytes,
                t_comp_pred=self.t_comp_pred)
            for m in migr:
                if m.to_path == "compute" and m.chunk in stream_q \
                        and m.chunk not in store_hits:
                    stream_q.remove(m.chunk)
                    comp_q.insert(0, m.chunk)
                    n_migr += 1
                elif m.to_path == "stream" and m.chunk in comp_q:
                    # never strand a compute-assigned dependent: its
                    # layer dep requires this chunk to be *computed*
                    dependent = (m.chunk.l + 1 < g.n_l and
                                 Chunk(m.chunk.t, m.chunk.l + 1,
                                       m.chunk.h) in comp_q)
                    if not dependent:
                        comp_q.remove(m.chunk)
                        stream_q.append(m.chunk)
                        n_migr += 1

        guard = 0
        while done < total:
            guard += 1
            if guard > 50 * total + 1000:
                raise RuntimeError("engine livelock")
            progressed = False
            # start network transfer
            if not net_busy and stream_q:
                c = stream_q.pop(0)
                nbytes = self.chunk_bytes[c]
                t_proc = self.profile.t_proc(nbytes)
                is_hit = c in store_hits
                if is_hit:
                    # cached in the cloud store: ride the cached-egress leg
                    yield StoreHit(c, nbytes, t_proc)
                    n_store_hits += 1
                    bytes_hit_stream += nbytes
                else:
                    if self.store_model is not None:
                        # miss: the origin encodes before it streams
                        # (0.0 at the model's defaults — bit-identical)
                        t_proc += t_store_miss_encode(nbytes,
                                                      self.store_model)
                    yield StreamStart(c, nbytes, t_proc)
                net_busy = True
                inflight += 1
                proc_busy += t_proc
                bytes_streamed += nbytes
                if c in attempted:
                    bytes_restreamed += nbytes
                attempted.add(c)
                pending_stream = (c, nbytes, t_proc, is_hit)
                progressed = True
            # start compute on first ready chunk in priority order
            if not dev_busy:
                started = None
                for i, c in enumerate(comp_q):
                    if g.compute_ready(c, state):
                        started = comp_q.pop(i)
                        break
                if started is not None:
                    u = util_fn() if util_fn is not None else None
                    dt = self._t_comp_actual(started, rng, u)
                    ack = yield ComputeStart(started, dt)
                    dev_busy = True
                    inflight += 1
                    comp_busy += dt
                    submit_t[started] = now
                    if isinstance(ack, StartAck) and ack.t_start is None:
                        # queued on the device server: the actual service
                        # interval arrives with the Completion
                        deferred.add(started)
                    elif self.controller:
                        t0 = ack.t_start if isinstance(ack, StartAck) \
                            else now
                        self.controller.record_compute(
                            t0 + dt, dt, self.t_comp_pred[started])
                    progressed = True
            if inflight == 0:
                if not progressed:
                    if comp_q and not stream_q:
                        # dependency-starved compute chunks (e.g. after a
                        # bad migration): streaming is always feasible
                        stream_q.append(comp_q.pop(0))
                        continue
                    raise RuntimeError("engine stalled")
                continue
            # park until the driver delivers this request's next completion
            ev = yield Wait()
            if isinstance(ev, StreamLost):
                # mid-transfer route loss: roll back the optimistic
                # accounting from this attempt's StreamStart (the bytes
                # never arrived, its decode tail is never paid), wasted
                # wire bytes land in bytes_lost, and the chunk re-enters
                # the head of the stream backlog for re-route / flip
                assert pending_stream is not None \
                    and pending_stream[0] == ev.chunk, (pending_stream, ev)
                c, nbytes, t_proc, is_hit = pending_stream
                pending_stream = None
                inflight -= 1
                net_busy = False
                now = max(now, ev.t_s)
                n_lost += 1
                bytes_lost += ev.nbytes_delivered
                bytes_streamed -= nbytes
                proc_busy -= t_proc
                if is_hit:
                    n_store_hits -= 1
                    bytes_hit_stream -= nbytes
                stream_q.insert(0, c)
                if self.controller is not None:
                    self.controller.note_loss(
                        now, nbytes_lost=ev.nbytes_delivered)
                    controller_boundary()
                continue
            assert isinstance(ev, Completion), ev
            inflight -= 1
            now = max(now, ev.t_end)
            c = ev.chunk
            i = g.index(c)
            timeline.append((ev.t_start, ev.t_end, ev.path, c))
            if ev.path == "stream":
                net_busy = False
                pending_stream = None
                stream_busy += ev.t_end - ev.t_start
                state[i] = State.STREAMED
                streamed_set.add(c)
                if self.controller:
                    self.controller.record_stream(now, self.chunk_bytes[c])
            else:
                dev_busy = False
                state[i] = State.COMPUTED
                computed_set.add(c)
                if c in deferred:
                    deferred.discard(c)
                    wait = max(ev.t_start - submit_t.get(c, ev.t_start),
                               0.0)
                    compute_wait += wait
                    n_queued += 1
                    if self.controller:
                        service = max(ev.t_end - ev.t_start, 1e-9)
                        self.controller.record_compute(
                            ev.t_end, service, self.t_comp_pred[c])
                        self.controller.record_queue_wait(
                            ev.t_end, wait, service)
            done += 1
            # controller migrations at event boundary
            if self.controller is not None:
                controller_boundary()

        if self.max_new_tokens <= 0:
            # first-token-only accounting (bit-identical to pre-decode
            # behaviour): TTFT = context completion + analytic one-token
            # forward; the response "ends" at the first token
            t_first = decode_first_token_seconds(self.cfg_model, context_len,
                                                 self.profile)
            ttft = now + t_first
            meter = EnergyMeter(self.profile,
                                compute_busy_s=comp_busy + t_first,
                                nic_busy_s=stream_busy, wall_s=ttft - t_start)
            return EngineResult(
                ttft_s=ttft, context_done_s=now, energy=meter.breakdown(),
                n_streamed=len(streamed_set), n_computed=len(computed_set),
                n_migrations=n_migr, stream_busy_s=stream_busy,
                compute_busy_s=comp_busy, proc_busy_s=proc_busy,
                timeline=timeline, streamed_set=streamed_set,
                computed_set=computed_set, bytes_streamed=bytes_streamed,
                compute_wait_s=compute_wait, n_compute_queued=n_queued,
                ttlt_s=ttft, token_times=(ttft,),
                n_reused=n_reused, n_store_hits=n_store_hits,
                bytes_hit_stream=bytes_hit_stream,
                n_lost=n_lost, bytes_lost=bytes_lost,
                bytes_restreamed=bytes_restreamed)

        # ---- decode phase: the driver owns token timing (batched) ----
        t_ctx_done = now
        yield DecodeStart(context_len=context_len,
                          n_tokens=self.max_new_tokens)
        token_t: list[float] = []
        decode_busy = 0.0
        while len(token_t) < self.max_new_tokens:
            ev = yield Wait()
            assert isinstance(ev, DecodeTick), ev
            token_t.extend(ev.token_times)
            decode_busy += ev.busy_share_s
            now = max(now, ev.t_end)
        assert len(token_t) == self.max_new_tokens, \
            (len(token_t), self.max_new_tokens)
        ttft, ttlt = token_t[0], token_t[-1]
        n_out = len(token_t)
        meter = EnergyMeter(self.profile,
                            compute_busy_s=comp_busy + decode_busy,
                            nic_busy_s=stream_busy, wall_s=ttlt - t_start)
        return EngineResult(
            ttft_s=ttft, context_done_s=t_ctx_done,
            energy=meter.breakdown(),
            n_streamed=len(streamed_set), n_computed=len(computed_set),
            n_migrations=n_migr, stream_busy_s=stream_busy,
            compute_busy_s=comp_busy, proc_busy_s=proc_busy,
            timeline=timeline, streamed_set=streamed_set,
            computed_set=computed_set, bytes_streamed=bytes_streamed,
            compute_wait_s=compute_wait, n_compute_queued=n_queued,
            n_tokens_out=n_out, ttlt_s=ttlt,
            tpot_s=(ttlt - ttft) / max(n_out - 1, 1),
            decode_busy_s=decode_busy, token_times=tuple(token_t),
            n_reused=n_reused, n_store_hits=n_store_hits,
            bytes_hit_stream=bytes_hit_stream,
            n_lost=n_lost, bytes_lost=bytes_lost,
            bytes_restreamed=bytes_restreamed)

    # ------------------------------------------------------------------
    # Classic single-request driver (exclusive link + device)
    # ------------------------------------------------------------------
    def run(self, schedule: Schedule, *, context_len: int) -> EngineResult:
        gen = self.session(schedule, context_len=context_len)
        now = 0.0
        # at most one stream + one compute in flight for a single request
        inflight: list[tuple[float, float, str, Chunk]] = []
        pending_decode: Optional[DecodeDone] = None
        try:
            ev = next(gen)
            while True:
                if isinstance(ev, StreamStart):
                    t_end = self.bw.finish_time(now, ev.nbytes) + ev.t_proc
                    inflight.append((t_end, now, "stream", ev.chunk))
                    ev = gen.send(None)
                elif isinstance(ev, StoreHit):
                    # classic driver has no shared egress stage to bypass;
                    # the hit still pays the store's service latency
                    lat = (self.store_model.hit_latency_s
                           if self.store_model is not None else 0.0)
                    t_end = (self.bw.finish_time(now, ev.nbytes)
                             + ev.t_proc + lat)
                    inflight.append((t_end, now, "stream", ev.chunk))
                    ev = gen.send(None)
                elif isinstance(ev, ComputeStart):
                    inflight.append((now + ev.duration_s, now, "compute",
                                     ev.chunk))
                    ev = gen.send(None)
                elif isinstance(ev, DecodeStart):
                    # exclusive device: serial batch-of-1 decode, one step
                    # per token over the growing context
                    ts, t, busy = [], now, 0.0
                    for i in range(ev.n_tokens):
                        dt = decode_step_seconds(
                            self.cfg_model, [ev.context_len + i],
                            self.profile)
                        t += dt
                        busy += dt
                        ts.append(t)
                    pending_decode = DecodeDone(
                        t_start=now, t_end=t, token_times=tuple(ts),
                        batch_size=1, busy_share_s=busy)
                    ev = gen.send(None)
                elif pending_decode is not None:        # Wait (decoding)
                    now = pending_decode.t_end
                    ev = gen.send(pending_decode)
                    pending_decode = None
                else:                                   # Wait
                    inflight.sort(key=lambda e: e[0])
                    t_end, t_st, path, c = inflight.pop(0)
                    now = max(now, t_end)
                    ev = gen.send(Completion(path, c, t_st, now))
        except StopIteration as stop:
            return stop.value
