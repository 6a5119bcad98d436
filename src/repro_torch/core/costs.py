"""Per-chunk streaming / computation cost models + energy accounting.

Two roles:
 1. *Planning* costs (what the scheduler sees): t_stream from compressed
    chunk bytes and profiled mean bandwidth (paper Eq. under (1)); t_comp
    from the latency predictor (core.predictor).
 2. *Ground truth* (what the simulated device does): a nonlinear
    block-sparse-attention latency function with launch inefficiency,
    utilization slowdown and noise — the thing the MLP learns and the
    analytical roofline baseline fails to capture (paper §IV-C / Fig. 8).

Device profiles: the paper's edge platforms plus a TPU-v5e single-chip
profile (our deployment target).

Shared-resource models (:class:`SharedLinkModel`, :class:`RunQueueModel`)
parameterize the serving layer's resource servers
(``repro.serving.resources``): contention efficiency for fair-shared
links, slot count + discipline for the explicit device run queue.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    peak_flops: float            # dense peak
    hbm_bw: float                # bytes/s
    compute_power_w: float       # active compute power
    nic_power_w: float           # active NIC power
    idle_power_w: float
    # block-sparse attention non-idealities (ground truth)
    eff_max: float               # peak fraction attainable by the kernel
    s_half: float                # active-block count at half efficiency
    util_slowdown: float         # slope of contention slowdown
    kernel_overhead_s: float     # fixed per-chunk launch overhead
    proc_fixed_s: float          # fixed per-chunk post-reception overhead
    decode_bw: float             # entropy-decode + dequant throughput (B/s)
    t_proj_s: float              # final-layer projection-only chunk

    def t_proc(self, nbytes: float) -> float:
        """Post-reception decode + dequant time for one chunk."""
        return self.proc_fixed_s + nbytes / self.decode_bw


PROFILES: dict[str, DeviceProfile] = {
    # numbers chosen to land in the paper's measured ranges (Table I, Fig. 3)
    "jetson-orin": DeviceProfile(
        "jetson-orin", peak_flops=20e12, hbm_bw=102e9,
        compute_power_w=25.0, nic_power_w=2.5, idle_power_w=5.0,
        eff_max=0.060, s_half=24.0, util_slowdown=0.65,
        kernel_overhead_s=9e-5, proc_fixed_s=8e-5, decode_bw=250e6,
        t_proj_s=1.2e-4),
    "jetson-agx": DeviceProfile(
        "jetson-agx", peak_flops=40e12, hbm_bw=205e9,
        compute_power_w=30.0, nic_power_w=2.5, idle_power_w=8.0,
        eff_max=0.068, s_half=20.0, util_slowdown=0.60,
        kernel_overhead_s=7e-5, proc_fixed_s=6e-5, decode_bw=350e6,
        t_proj_s=9e-5),
    "laptop-5080": DeviceProfile(
        "laptop-5080", peak_flops=110e12, hbm_bw=640e9,
        compute_power_w=28.0 * 4, nic_power_w=2.0, idle_power_w=15.0,
        eff_max=0.080, s_half=16.0, util_slowdown=0.55,
        kernel_overhead_s=4e-5, proc_fixed_s=3e-5, decode_bw=800e6,
        t_proj_s=5e-5),
    "redmi-k80": DeviceProfile(
        "redmi-k80", peak_flops=8e12, hbm_bw=68e9,
        compute_power_w=9.0, nic_power_w=2.8, idle_power_w=2.0,
        eff_max=0.050, s_half=30.0, util_slowdown=0.75,
        kernel_overhead_s=1.5e-4, proc_fixed_s=1.2e-4, decode_bw=120e6,
        t_proj_s=2e-4),
    "tpu-v5e-1chip": DeviceProfile(
        "tpu-v5e-1chip", peak_flops=197e12, hbm_bw=819e9,
        compute_power_w=170.0, nic_power_w=5.0, idle_power_w=60.0,
        eff_max=0.450, s_half=12.0, util_slowdown=0.45,
        kernel_overhead_s=2.5e-5, proc_fixed_s=1e-5, decode_bw=2e9,
        t_proj_s=3e-5),
}


@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    name: str
    mean_bw: float               # bytes/s
    std_bw: float
    corr_tau_s: float = 0.8      # OU-process correlation time
    floor_bw: float = 2e6

    def trace(self, rng: np.random.Generator, duration_s: float,
              dt: float = 0.01) -> np.ndarray:
        """Ornstein-Uhlenbeck bandwidth trace, clipped at floor."""
        n = int(np.ceil(duration_s / dt)) + 1
        out = np.empty(n)
        x = self.mean_bw
        a = dt / self.corr_tau_s
        sig = self.std_bw * np.sqrt(2 * a)
        for i in range(n):
            out[i] = x
            x = x + a * (self.mean_bw - x) + sig * rng.normal()
        return np.maximum(out, self.floor_bw)


@dataclasses.dataclass(frozen=True)
class SharedLinkModel:
    """Shared last-hop link serving N concurrent KV streams.

    One capacity trace (a ``NetworkProfile``) is fair-shared among active
    flows; contention is not free — per-flow protocol overhead (MAC
    contention, cwnd thrash, header amplification) shaves the *aggregate*
    goodput as flows are added:

        eta(n) = max(min_efficiency, 1 - contention_overhead * (n - 1))
        per-flow share(n) = eta(n) / n

    ``eta(1) == 1`` so a single flow reproduces exclusive-link semantics
    exactly (the serving cluster degenerates to the classic per-request
    engine). Used by ``repro.serving.cluster.SharedLinkArbiter``.
    """
    profile: NetworkProfile
    contention_overhead: float = 0.05
    min_efficiency: float = 0.65

    def aggregate_efficiency(self, n_flows: int) -> float:
        if n_flows <= 1:
            return 1.0
        return max(self.min_efficiency,
                   1.0 - self.contention_overhead * (n_flows - 1))

    def per_flow_fraction(self, n_flows: int) -> float:
        """Fraction of the instantaneous trace capacity one flow gets."""
        if n_flows <= 0:
            return 1.0
        return self.aggregate_efficiency(n_flows) / n_flows


NETWORKS: dict[str, NetworkProfile] = {
    # paper §III: cloud-to-device 850 +- 264 Mbps
    "campus-wifi": NetworkProfile("campus-wifi", 850e6 / 8, 264e6 / 8),
    # paper §VI: Wi-Fi 6 testbed end-to-end 0.64 Gbps
    "wifi6-cloud": NetworkProfile("wifi6-cloud", 640e6 / 8, 200e6 / 8),
    # congested variants for Fig. 13 (scalar stand-ins; the two-stage
    # LinkTopology models the same scenarios structurally)
    "congested-2dev": NetworkProfile("congested-2dev", 760e6 / 8, 330e6 / 8),
    "congested-5dev": NetworkProfile("congested-5dev", 660e6 / 8, 470e6 / 8),
    # per-device NIC / last-metre hop for two-stage topologies: a device
    # radio is steadier than the contended AP uplink but not much faster,
    # so with 1 flow the NIC bottlenecks and with >= 2 flows the shared
    # uplink does — the crossover the Fig. 13 congested-AP study probes
    "device-nic": NetworkProfile("device-nic", 600e6 / 8, 60e6 / 8,
                                 corr_tau_s=1.5),
    # cloud-egress trunk for three-hop trees (NIC -> AP uplink ->
    # egress): a wired hop shared by *all* APs — generously provisioned
    # for a handful of flows, the fleet-wide bottleneck once enough APs
    # pull concurrently (the bench_topology_tree starved-egress study
    # dials the mean down further)
    "cloud-egress": NetworkProfile("cloud-egress", 1.6e9 / 8, 200e6 / 8,
                                   corr_tau_s=0.5),
    # datacenter-ish for the TPU profile
    "dcn-25g": NetworkProfile("dcn-25g", 25e9 / 8, 2e9 / 8, corr_tau_s=0.2),
}


@dataclasses.dataclass(frozen=True)
class RunQueueModel:
    """Configuration of the explicit device run queue (the queueing
    counterpart of :class:`SharedLinkModel`): ``capacity`` parallel
    service slots and a scheduling ``discipline``:

      - ``"fifo"`` — jobs start in global submission order;
      - ``"wfq"``  — weighted fair queueing across request flows (a flow
        with weight w gets a ~w-proportional share of device time under
        backlog);
      - ``"srpt"`` — shortest-remaining-first across flows, preemptive
        at chunk boundaries, with a deadline floor so long flows are
        deferred but never starved past their TTFT deadline
        (``deadline_floor_s``: a queued job whose deadline is within
        this window of now preempts the SRPT order, EDF-first).

    Consumed by ``repro.serving.resources.DeviceRunQueue``. When a
    cluster runs with a RunQueueModel, compute contention is expressed as
    *waiting* (queueing delay) instead of the scalar ``util`` dilation of
    :meth:`GroundTruthLatency.attn_seconds` — the engine then receives
    util 0 for fleet-internal contention."""
    capacity: int = 1
    discipline: str = "fifo"
    deadline_floor_s: float = 0.5

    def __post_init__(self):
        assert self.capacity >= 1, self.capacity
        assert self.discipline in ("fifo", "wfq", "srpt"), self.discipline
        assert self.deadline_floor_s >= 0, self.deadline_floor_s


# ---------------------------------------------------------------------------
# KV memory: disk tier + per-device memory-server configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiskTierProfile:
    """Bandwidth/latency profile of the local storage tier backing the
    KV memory server (DRAM -> disk demotion, KVSwap-style). Unlike the
    fluid link stages, disk transfers are modeled as a serial FIFO
    server (``repro.serving.resources.DiskServer``): one transfer at a
    time, each paying a fixed per-op latency plus bytes over the
    direction's sequential bandwidth — the access pattern KV demotion
    and reload actually produce (large sequential extents)."""
    name: str
    read_bw: float               # bytes/s, sequential read
    write_bw: float              # bytes/s, sequential write
    latency_s: float = 1.5e-4    # fixed per-op submission latency


DISK_TIERS: dict[str, DiskTierProfile] = {
    # mobile UFS 3.1 (sequential ~1.8/0.9 GB/s) — the default edge tier
    "ufs-3.1": DiskTierProfile("ufs-3.1", 1.8e9, 0.9e9, 1.5e-4),
    # NVMe on an edge box / laptop
    "nvme-edge": DiskTierProfile("nvme-edge", 3.5e9, 2.5e9, 8e-5),
    # older phones: eMMC 5.1 sequential ~300/150 MB/s
    "emmc-5.1": DiskTierProfile("emmc-5.1", 0.30e9, 0.15e9, 4e-4),
}


def t_disk_read(nbytes: float, disk: DiskTierProfile,
                n_ops: int = 1) -> float:
    """Service time of a disk-tier read (no queueing): per-op latency
    plus bytes over the sequential read bandwidth."""
    return n_ops * disk.latency_s + nbytes / disk.read_bw


def t_disk_write(nbytes: float, disk: DiskTierProfile,
                 n_ops: int = 1) -> float:
    """Service time of a disk-tier write (no queueing)."""
    return n_ops * disk.latency_s + nbytes / disk.write_bw


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Configuration of the per-device KV memory server
    (``repro.serving.memory.KVMemoryServer``) — the memory counterpart
    of :class:`SharedLinkModel` / :class:`RunQueueModel`.

    Parameters
    ----------
    capacity_bytes : DRAM budget for resident KV on each device; ``None``
        tracks residency (peak/percentile telemetry) without ever
        evicting — bit-identical traces to a cluster without a memory
        server.
    policy : victim selection under pressure —
        ``"lru"`` (least-recently-used among ready, unpinned residents),
        ``"idle"`` (longest-idle among sequences *outside* the active
        decode batch first — never thrashes a decoding sequence while a
        parked one can pay instead; falls back to LRU when every
        candidate is active), or
        ``"bits"`` (evict-to-lower-bits: requantize the LRU victim's
        resident KV down the ``compression.quantize.BITRATE_LEVELS``
        ladder in place — the sequence keeps decoding at reduced
        fidelity — and only demote/drop once it hits the ladder floor).
    disk : backing tier for demotion — a :class:`DiskTierProfile`, a
        ``DISK_TIERS`` name, or ``None`` (no tier: eviction drops the KV
        outright and reload must restream or recompute).
    reload : how an evicted context is restored —
        ``"planner"`` (per-chunk overhead-aware split across disk read /
        cloud restream / local recompute, greedy LPT over the projected
        path loads — the SparKV decision re-posed at reload time),
        ``"restream"`` / ``"recompute"`` / ``"disk"`` (single-path
        baselines; ``"disk"`` falls back to restream when the KV was
        dropped without a disk copy).
    gate_frac : admission gate — hold a queued arrival while projected
        residency (current + the request's full context) exceeds
        ``gate_frac * capacity_bytes``; ``None`` disables gating. The
        gate never holds an empty device (no deadlock).
    resident_bits : bit-width resident KV is accounted at before any
        evict-to-lower-bits downgrade (16 = bf16, the engine's decode
        cost model assumption).
    cold_frac : the "bits" policy's cold-pool fraction — the share of a
        victim's resident KV (its low-saliency chunks) requantized
        first under pressure; the hot remainder only degrades once the
        cold pool reaches the ladder floor. 1.0 (default) downgrades
        the whole resident at once, exactly the pre-cold-pool behavior.
    """
    capacity_bytes: Optional[float] = None
    policy: str = "lru"
    disk: object = "ufs-3.1"      # DiskTierProfile | name | None
    reload: str = "planner"
    gate_frac: Optional[float] = None
    resident_bits: int = 16
    # fraction of a resident's KV treated as cold (low-saliency) by the
    # "bits" eviction policy: pressure downgrades only the cold pool
    # until it hits the ladder floor, then the hot remainder. 1.0
    # (default) downgrades the whole resident at once — the exact
    # pre-cold-pool behavior.
    cold_frac: float = 1.0

    def __post_init__(self):
        assert self.capacity_bytes is None or self.capacity_bytes > 0
        assert self.policy in ("lru", "idle", "bits"), self.policy
        assert self.reload in ("planner", "restream", "recompute",
                               "disk"), self.reload
        if isinstance(self.disk, str):
            assert self.disk in DISK_TIERS, self.disk
        assert self.gate_frac is None or 0 < self.gate_frac
        assert self.resident_bits > 0
        assert 0.0 < self.cold_frac <= 1.0, self.cold_frac

    @property
    def disk_profile(self) -> Optional[DiskTierProfile]:
        if self.disk is None:
            return None
        return DISK_TIERS[self.disk] if isinstance(self.disk, str) \
            else self.disk


@dataclasses.dataclass(frozen=True)
class KVStoreModel:
    """Configuration of the cloud-side content-addressed KV store
    (``repro.serving.kvstore.CloudKVStore``) and the per-device prefix
    cache — the cross-request reuse counterpart of :class:`MemoryModel`.

    Hit economics: the store caches, per content key, the transfer-ready
    encoded bitstream replicated to the edge of the cloud path. A **hit**
    replaces the encode+stream cost with a per-hit egress cost
    (:func:`t_store_hit`): the cached bytes skip the cloud-side encode
    pipeline and, on tree topologies with a cloud-egress stage, bypass
    that shared stage entirely (the bytes are already at the AP side of
    it). A **miss** is the ordinary origin path — with the default
    ``encode_fixed_s=0`` / ``encode_bw=None`` it is bit-identical to a
    store-less fleet (registration-time artifacts are pre-encoded, the
    pre-reuse semantics); arming the encode knobs charges misses the
    cloud-side quantize+entropy-encode latency before their bytes hit
    the wire. A **device prefix hit** (the requesting device still holds
    the chunk's assembled KV from an earlier turn) costs nothing on the
    link at all.

    Parameters
    ----------
    capacity_bytes : cloud store budget for cached bitstreams; ``None``
        is unbounded. Residency never exceeds this (LRU/LFU eviction on
        insert; an artifact larger than the whole store is refused).
    policy : ``"lru"`` | ``"lfu"`` victim selection.
    hit_latency_s : store lookup + cached read latency added to each hit
        chunk's device-side tail.
    device_capacity_bytes : per-device prefix-cache budget (assembled KV
        a device keeps addressable across turns); ``None`` defers to the
        KV memory server when one is armed, else unbounded.
    encode_fixed_s / encode_bw : per-chunk cloud-side encode launch
        overhead and throughput (bytes/s) charged on a miss. Defaults
        (0.0 / ``None`` = free) keep the miss path bit-identical to a
        store-less fleet.
    """
    capacity_bytes: Optional[float] = None
    policy: str = "lru"
    hit_latency_s: float = 2e-4
    device_capacity_bytes: Optional[float] = None
    encode_fixed_s: float = 0.0
    encode_bw: Optional[float] = None

    def __post_init__(self):
        assert self.capacity_bytes is None or self.capacity_bytes > 0
        assert self.policy in ("lru", "lfu"), self.policy
        assert self.hit_latency_s >= 0 and self.encode_fixed_s >= 0
        assert self.encode_bw is None or self.encode_bw > 0
        assert self.device_capacity_bytes is None \
            or self.device_capacity_bytes > 0


def t_store_hit(chunk_bytes: float, mean_bw: float, profile,
                store: KVStoreModel) -> float:
    """Per-hit egress cost of a cached chunk: store read latency + the
    cached bitstream over the (egress-bypassing) link + the on-device
    decode tail. Replaces encode+stream for content-key hits."""
    return store.hit_latency_s + chunk_bytes / mean_bw \
        + profile.t_proc(chunk_bytes)


def t_store_miss_encode(chunk_bytes: float, store: KVStoreModel) -> float:
    """Cloud-side encode latency a store miss pays before its first byte
    egresses. Exactly 0.0 at the defaults (pre-encoded artifacts), so a
    0%-hit fleet stays bit-identical to a store-less one."""
    if store.encode_bw is None:
        return store.encode_fixed_s
    return store.encode_fixed_s + chunk_bytes / store.encode_bw


# ---------------------------------------------------------------------------
# Ground-truth chunk latency (the simulated device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroundTruthLatency:
    """Nonlinear block-sparse attention latency. Deliberately NOT the
    roofline form: efficiency saturates with active blocks, contention
    multiplies, noise is lognormal."""
    profile: DeviceProfile
    head_dim: int
    q_block: int = 128
    kv_block: int = 128
    chunk_tokens: int = 1024
    dtype_bytes: int = 2
    noise_sigma: float = 0.05

    def block_flops(self) -> float:
        # qk^T + pv per (q_block, kv_block) tile
        return 4.0 * self.q_block * self.kv_block * self.head_dim

    def attn_seconds(self, active_blocks: float, util: float,
                     rng: Optional[np.random.Generator] = None) -> float:
        p = self.profile
        s = max(float(active_blocks), 0.0)
        eff = p.eff_max * s / (s + p.s_half)
        work = self.block_flops() * s
        t = work / (p.peak_flops * max(eff, 1e-3)) + p.kernel_overhead_s
        t *= 1.0 + p.util_slowdown * float(util) / max(1 - 0.9 * float(util),
                                                       0.1)
        if rng is not None:
            t *= float(np.exp(rng.normal(0.0, self.noise_sigma)))
        return t

    def dense_seconds(self, cfg) -> float:
        """Per-chunk non-attention ops (qkv/o proj, norm, FFN) — near-
        constant offset (paper §IV-C)."""
        d = cfg.d_model
        ff = 3 if cfg.activation in ("swiglu", "geglu") else 2
        d_ff_active = (cfg.d_ff if cfg.moe is None
                       else cfg.d_ff * cfg.moe.experts_per_token)
        flops = 2 * self.chunk_tokens * (
            d * (cfg.num_heads + 2 * cfg.num_kv_heads)
            * cfg.resolved_head_dim
            + cfg.num_heads * cfg.resolved_head_dim * d
            + ff * d * d_ff_active)
        return flops / (self.profile.peak_flops * 0.65)

    def roofline_estimate(self, active_blocks: float) -> float:
        """The analytical baseline the paper compares against: ignores
        launch inefficiency, fragmentation and contention."""
        p = self.profile
        s = max(float(active_blocks), 0.0)
        w = self.block_flops() * s
        q = s * self.kv_block * self.head_dim * 2 * self.dtype_bytes \
            + self.chunk_tokens * self.head_dim * self.dtype_bytes
        return max(w / p.peak_flops, q / p.hbm_bw)


# ---------------------------------------------------------------------------
# Streaming cost
# ---------------------------------------------------------------------------


def t_stream(chunk_bytes: float, mean_bw: float, profile) -> float:
    """Paper: t_stream(c) = b_c / bw-bar + t_proc(c)."""
    return chunk_bytes / mean_bw + profile.t_proc(chunk_bytes)


def chunk_bytes_at_bits(nbytes: float, from_bits: float,
                        to_bits: float) -> float:
    """Wire/resident bytes of a chunk re-expressed at another
    quantization width: payload scales linearly in bits (the per-group
    header share is folded in — it is <2% at the measured group sizes).
    The single byte<->bits model every per-chunk-bits consumer (planner
    scaling, SLO cold downgrade, memory requantization) shares, so their
    accounting can never drift apart."""
    return nbytes * to_bits / from_bits


# ---------------------------------------------------------------------------
# Energy accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EnergyMeter:
    profile: DeviceProfile
    compute_busy_s: float = 0.0
    nic_busy_s: float = 0.0
    wall_s: float = 0.0

    def energy_j(self) -> float:
        p = self.profile
        return (p.compute_power_w * self.compute_busy_s
                + p.nic_power_w * self.nic_busy_s
                + p.idle_power_w * self.wall_s)

    def breakdown(self) -> dict:
        p = self.profile
        return {
            "compute_j": p.compute_power_w * self.compute_busy_s,
            "nic_j": p.nic_power_w * self.nic_busy_s,
            "idle_j": p.idle_power_w * self.wall_s,
            "total_j": self.energy_j(),
        }
