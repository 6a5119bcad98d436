"""Fleet traffic generator: arrival processes + request mixes.

Produces ``RequestSpec`` lists for ``repro.serving.cluster``:

  - **poisson**: memoryless arrivals at ``rate_rps`` (the open-loop
    baseline for p50/p99 TTFT under load);
  - **bursty**: a two-state Markov-modulated Poisson process — an "on"
    state multiplies the base rate by ``burst_factor`` (flash crowds /
    synchronized app wakeups), "off" drops to the base rate;
  - **uniform**: deterministic equal spacing (useful for regression
    tests where arrival jitter is noise).

Any base process can additionally be shaped onto an inhomogeneous rate
by the ``diurnal_*`` / ``flash_crowds`` knobs — a deterministic
time-rescaling (no extra randomness) that compresses arrivals where the
modulated rate exceeds the base rate; disarmed knobs are bit-identical.

Request mixes draw context lengths per dataset profile (rounded to whole
chunks) and policies from a weighted table, so one trace can interleave
sparkv / strong_hybrid / local_prefill requests the way a real fleet
mixes device capabilities. For the resource-server cluster, traces can
also spread requests over ``n_devices`` (round-robin, or weighted via
``device_mix`` for asymmetric-NIC fleets — the NIC/uplink/egress link
tree routes per device, and the cluster's ``ap_of_device`` assigns each
device to its access point) and draw per-request WFQ weights from
``weight_mix`` (interactive vs. background service classes).

SLO classes: ``slo_mix`` draws a named service class per request, each
carrying a TTFT deadline (or ``None`` for best-effort) — e.g. a 70/30
interactive/batch split where only interactive requests have deadlines.
4-tuple entries add a per-token TPOT SLO for the decode phase. The
cluster's SLO admission layer (``repro.serving.slo``) consumes the
deadlines; the class name is the reporting bucket for per-class
attainment in the ``FleetReport``.

Decode: ``out_len_mix`` draws a response length per request (chat
replies vs. long generations), setting ``RequestSpec.max_new_tokens`` so
the fleet's continuous decode batches carry a realistic length mix; an
empty mix keeps every spec first-token-only.

Cross-request KV reuse: with ``prefix_pool > 0`` every request carries
prefix-closed span content ids (``repro.core.chunks.span_content_id``
hash chains). The leading ``prefix_frac`` of each request's token blocks
comes from a Zipf-popular pool of shared prefixes (system prompts / RAG
documents — rank ``r`` drawn with probability ∝ ``1/r^prefix_zipf_a``),
the tail is request-unique. Reuse draws come from a **separate** rng
stream (``seed + REUSE_SEED_SALT``), so arming the knobs never perturbs
the base trace — every other spec field is bit-identical to
``prefix_pool=0``. ``prefix_frac=0.0`` is the 0%-overlap configuration:
content ids present (the store counts misses) but never two alike.
:func:`session_trace` generates multi-turn chat sessions instead: each
turn re-sends the whole history, so turn ``j``'s content chain is turn
``j-1``'s plus ``turn_growth_chunks`` fresh blocks — the on-device
prefix-reuse workload (same device the whole session, think-time gaps
between turns).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.chunks import span_content_id
from repro_torch.data.workloads import DATASETS
from repro_torch.serving.cluster import RequestSpec

# offset of the reuse rng stream from the trace seed: reuse draws never
# consume from the base stream, so prefix_pool=0 vs >0 traces share every
# non-reuse field bit-for-bit
REUSE_SEED_SALT = 104729


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    rate_rps: float = 0.5
    arrival: str = "poisson"            # poisson | bursty | uniform
    # bursty (MMPP) knobs
    burst_factor: float = 6.0           # rate multiplier while "on"
    mean_on_s: float = 4.0
    mean_off_s: float = 12.0
    # request mix
    context_mix: tuple = (("longchat", 1.0),)     # (dataset, weight)
    policy_mix: tuple = (("sparkv", 1.0),)        # (policy, weight)
    context_jitter: float = 0.25        # lognormal sigma on dataset mean_len
    min_context: int = 2048
    max_context: int = 16384
    chunk_tokens: int = 1024
    # resource-server routing
    n_devices: int = 1                  # round-robin device assignment
    # (device, draw weight) — overrides round-robin when non-empty, so
    # asymmetric-NIC fleets can skew load toward fast-NIC devices (the
    # cluster's ap_of_device then maps each device to its access point)
    device_mix: tuple = ()
    weight_mix: tuple = ((1.0, 1.0),)   # (wfq weight, draw weight)
    # SLO classes: (class name, ttft deadline_s | None, draw weight) or
    # (class name, ttft deadline_s | None, tpot_slo_s | None, draw weight)
    slo_mix: tuple = ()                 # empty = no deadlines
    # decode: response-length classes (n output tokens, draw weight);
    # empty = first-token-only fleets (max_new_tokens 0 on every spec)
    out_len_mix: tuple = ()
    # cross-request KV reuse: prefix_pool > 0 arms content-id generation
    # (0 keeps every spec anonymous — bit-identical to pre-reuse traces).
    # The leading prefix_frac of each request's token blocks is drawn
    # from a pool of prefix_pool shared chains with Zipf popularity
    # (p ∝ 1/rank^prefix_zipf_a); the tail is request-unique.
    prefix_pool: int = 0
    prefix_zipf_a: float = 1.1
    prefix_frac: float = 0.5
    # multi-turn sessions (session_trace only): (n turns, draw weight)
    # mix, mean exponential think time between turns, and how many fresh
    # chunk-sized blocks each turn appends to the re-sent history
    session_turns_mix: tuple = ((3, 1.0),)
    think_time_s: float = 8.0
    turn_growth_chunks: int = 1
    # hostile-world arrival shaping: a deterministic time-rescaling of
    # the base arrival process to an inhomogeneous rate (no extra rng —
    # disarmed knobs return the base times object untouched, so traces
    # stay bit-identical). diurnal_amp in [0, 1) modulates the rate by
    # 1 + amp*sin(2π t / period + phase); flash_crowds entries
    # (t_start_s, t_end_s, rate_multiplier) multiply the rate inside
    # their window (synchronized wakeups / stadium crowds).
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 60.0
    diurnal_phase: float = 0.0
    flash_crowds: tuple = ()


def _arrival_times(profile: TrafficProfile, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    if profile.arrival == "uniform":
        return np.arange(n) / max(profile.rate_rps, 1e-9)
    if profile.arrival == "poisson":
        gaps = rng.exponential(1.0 / profile.rate_rps, n)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    if profile.arrival == "bursty":
        # two-state MMPP, exponential sojourn in each state
        times = np.empty(n)
        t, state_end, on = 0.0, rng.exponential(profile.mean_off_s), False
        for i in range(n):
            rate = profile.rate_rps * (profile.burst_factor if on else 1.0)
            t += rng.exponential(1.0 / rate) if i else 0.0
            while t > state_end:
                on = not on
                state_end += rng.exponential(
                    profile.mean_on_s if on else profile.mean_off_s)
            times[i] = t
        return times
    raise ValueError(f"unknown arrival process {profile.arrival!r}")


def _shape_arrivals(profile: TrafficProfile,
                    times: np.ndarray) -> np.ndarray:
    """Warp base arrival times onto an inhomogeneous rate profile.

    Standard time-rescaling: if the base process has arrivals at
    cumulative unit-time ``u``, the shaped process places them at
    ``Λ⁻¹(u)`` where ``Λ(t) = ∫₀ᵗ m(s) ds`` and ``m`` is the rate
    multiplier (diurnal sinusoid × flash-crowd windows). Arrivals
    compress where ``m > 1`` and stretch where ``m < 1``; the inversion
    is deterministic, so disarmed knobs return ``times`` unchanged and
    armed ones consume no randomness."""
    if (profile.diurnal_amp <= 0.0 and not profile.flash_crowds) \
            or len(times) == 0:
        return times
    assert 0.0 <= profile.diurnal_amp < 1.0, profile.diurnal_amp
    dt = profile.diurnal_period_s / 256 if profile.diurnal_amp > 0 else 1.0
    for t0, t1, _ in profile.flash_crowds:
        assert t1 > t0, (t0, t1)
        dt = min(dt, (t1 - t0) / 16)
    dt = max(dt, 1e-4)
    n = 1024
    while True:
        grid = np.arange(n) * dt
        m = np.ones(n)
        if profile.diurnal_amp > 0:
            m += profile.diurnal_amp * np.sin(
                2 * np.pi * grid / profile.diurnal_period_s
                + profile.diurnal_phase)
        for t0, t1, mult in profile.flash_crowds:
            m[(grid >= t0) & (grid < t1)] *= mult
        lam = np.concatenate([[0.0],
                              np.cumsum((m[:-1] + m[1:]) * dt / 2)])
        if lam[-1] >= times[-1] or n >= 1 << 24:
            break
        n *= 2
    return np.interp(times, lam, grid)


def _weighted(table: tuple, rng: np.random.Generator) -> str:
    names = [k for k, _ in table]
    w = np.array([v for _, v in table], float)
    return names[rng.choice(len(names), p=w / w.sum())]


def _zipf_pmf(n: int, a: float) -> np.ndarray:
    """Explicit truncated-Zipf pmf: p(rank r) ∝ 1/r^a, r in 1..n."""
    p = 1.0 / np.arange(1, n + 1, dtype=float) ** a
    return p / p.sum()


def _content_chain(n_blocks: int, n_prefix: int, prefix_id: int,
                   unique_tag: str, *, base: tuple = ()) -> tuple:
    """Prefix-closed span-id chain: shared head, request-unique tail.

    Block ``j < n_prefix`` hashes ``prefix:<id>:<j>`` so every request
    drawing the same pool entry produces byte-identical leading ids (and
    therefore identical content keys — the store/prefix-cache hit path);
    later blocks hash ``<unique_tag>:<j>`` so tails never collide. When
    ``base`` is non-empty the chain continues from it instead (multi-turn
    history extension: ``base`` is the previous turn's full chain).
    """
    ids = list(base)
    prev = ids[-1] if ids else 0
    for j in range(len(ids), n_blocks):
        if j < n_prefix:
            tok = f"prefix:{prefix_id}:{j}".encode()
        else:
            tok = f"{unique_tag}:{j}".encode()
        prev = span_content_id(tok, prev)
        ids.append(prev)
    return tuple(ids)


def generate_trace(profile: TrafficProfile, n_requests: int,
                   *, seed: int = 0,
                   rng: Optional[np.random.Generator] = None
                   ) -> list[RequestSpec]:
    """Draw `n_requests` specs: arrival times + per-request mix."""
    rng = rng or np.random.default_rng(seed)
    arrivals = _shape_arrivals(profile,
                               _arrival_times(profile, n_requests, rng))
    wfq_weights = [w for w, _ in profile.weight_mix]
    wfq_p = np.array([v for _, v in profile.weight_mix], float)
    wfq_p /= wfq_p.sum()
    slo_p = None
    if profile.slo_mix:
        slo_p = np.array([e[-1] for e in profile.slo_mix], float)
        slo_p /= slo_p.sum()
    out_lens = [int(n) for n, _ in profile.out_len_mix]
    out_p = None
    if profile.out_len_mix:
        out_p = np.array([w for _, w in profile.out_len_mix], float)
        out_p /= out_p.sum()
    devices = [int(d) for d, _ in profile.device_mix]
    dev_p = None
    if profile.device_mix:
        assert all(0 <= d < max(profile.n_devices, 1) for d in devices), \
            f"device_mix entries out of range [0, {profile.n_devices})"
        dev_p = np.array([w for _, w in profile.device_mix], float)
        dev_p /= dev_p.sum()
    # reuse draws live on their own stream so arming prefix_pool never
    # shifts the base draw sequence (dataset/ctx/wfq/slo/out_len/device)
    reuse_rng = None
    zipf_p = None
    if profile.prefix_pool > 0:
        reuse_rng = np.random.default_rng(seed + REUSE_SEED_SALT)
        zipf_p = _zipf_pmf(profile.prefix_pool, profile.prefix_zipf_a)
    specs = []
    for i, t in enumerate(arrivals):
        ds_name = _weighted(profile.context_mix, rng)
        ds = DATASETS[ds_name]
        raw = ds.mean_len * np.exp(rng.normal(0.0, profile.context_jitter))
        raw = float(np.clip(raw, profile.min_context, profile.max_context))
        ctx = max(profile.chunk_tokens,
                  int(raw // profile.chunk_tokens) * profile.chunk_tokens)
        wfq_w = float(wfq_weights[rng.choice(len(wfq_weights), p=wfq_p)])
        slo_class, deadline, tpot_slo = "default", None, None
        if slo_p is not None:
            entry = profile.slo_mix[
                rng.choice(len(profile.slo_mix), p=slo_p)]
            if len(entry) == 4:          # (name, ttft, tpot, weight)
                slo_class, deadline, tpot_slo, _ = entry
            else:                        # legacy (name, ttft, weight)
                slo_class, deadline, _ = entry
        max_new = 0
        if out_p is not None:
            max_new = out_lens[rng.choice(len(out_lens), p=out_p)]
        dev = i % max(profile.n_devices, 1) if dev_p is None \
            else devices[rng.choice(len(devices), p=dev_p)]
        content_ids = None
        if reuse_rng is not None:
            n_blocks = max(ctx // profile.chunk_tokens, 1)
            n_prefix = min(int(round(profile.prefix_frac * n_blocks)),
                           n_blocks)
            pool_idx = int(reuse_rng.choice(profile.prefix_pool, p=zipf_p))
            content_ids = _content_chain(
                n_blocks, n_prefix, pool_idx, f"req:{seed}:{i}")
        specs.append(RequestSpec(
            arrival_s=float(t), context_len=ctx, dataset=ds_name,
            policy=_weighted(profile.policy_mix, rng), seed=seed + i,
            device=dev, weight=wfq_w,
            deadline_s=deadline, slo_class=slo_class,
            max_new_tokens=max_new, tpot_slo_s=tpot_slo,
            content_ids=content_ids))
    return specs


def session_trace(profile: TrafficProfile, n_sessions: int,
                  *, seed: int = 0) -> list[RequestSpec]:
    """Multi-turn chat sessions with cross-turn KV reuse.

    Each session pins one device (session affinity), opens with a
    context drawn like :func:`generate_trace`, and re-sends its whole
    history every turn: turn ``j``'s content chain is turn ``j-1``'s
    plus ``turn_growth_chunks`` fresh blocks, with exponential think
    time between turns. When ``prefix_pool > 0`` the opening turn's
    leading blocks come from the shared Zipf pool, so sessions also
    share cross-session prefixes; otherwise chains are session-unique
    (pure intra-session reuse). Specs carry ``session=<idx>`` so the
    report can group turns.
    """
    rng = np.random.default_rng(seed)
    reuse_rng = np.random.default_rng(seed + REUSE_SEED_SALT)
    zipf_p = (_zipf_pmf(profile.prefix_pool, profile.prefix_zipf_a)
              if profile.prefix_pool > 0 else None)
    starts = _arrival_times(profile, n_sessions, rng)
    turn_counts = [int(n) for n, _ in profile.session_turns_mix]
    turn_p = np.array([w for _, w in profile.session_turns_mix], float)
    turn_p /= turn_p.sum()
    max_blocks = max(profile.max_context // profile.chunk_tokens, 1)
    specs = []
    req_idx = 0
    for s, t0 in enumerate(starts):
        dev = s % max(profile.n_devices, 1)
        n_turns = turn_counts[rng.choice(len(turn_counts), p=turn_p)]
        ds_name = _weighted(profile.context_mix, rng)
        ds = DATASETS[ds_name]
        raw = ds.mean_len * np.exp(rng.normal(0.0, profile.context_jitter))
        raw = float(np.clip(raw, profile.min_context, profile.max_context))
        n_blocks = max(int(raw // profile.chunk_tokens), 1)
        n_prefix = 0
        pool_idx = 0
        if zipf_p is not None:
            n_prefix = min(int(round(profile.prefix_frac * n_blocks)),
                           n_blocks)
            pool_idx = int(reuse_rng.choice(profile.prefix_pool, p=zipf_p))
        ids: tuple = ()
        t = float(t0)
        for turn in range(n_turns):
            if turn > 0:
                t += float(rng.exponential(profile.think_time_s))
                n_blocks = min(n_blocks + profile.turn_growth_chunks,
                               max_blocks)
            ids = _content_chain(
                n_blocks, n_prefix, pool_idx,
                f"sess:{seed}:{s}:t{turn}", base=ids)
            specs.append(RequestSpec(
                arrival_s=t,
                context_len=n_blocks * profile.chunk_tokens,
                dataset=ds_name,
                policy=_weighted(profile.policy_mix, rng),
                seed=seed + req_idx, device=dev,
                content_ids=ids, session=s))
            req_idx += 1
    specs.sort(key=lambda sp: sp.arrival_s)
    return specs


def poisson_trace(n_requests: int, rate_rps: float, *,
                  policy: str = "sparkv", dataset: str = "longchat",
                  max_context: int = 8192, seed: int = 0
                  ) -> list[RequestSpec]:
    """Shorthand: homogeneous Poisson trace with a single policy."""
    prof = TrafficProfile(rate_rps=rate_rps, arrival="poisson",
                          context_mix=((dataset, 1.0),),
                          policy_mix=((policy, 1.0),),
                          max_context=max_context)
    return generate_trace(prof, n_requests, seed=seed)
