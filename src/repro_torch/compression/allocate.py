"""Per-chunk saliency scoring and declarative bit-allocation schedules.

"Don't Waste Bits"-style allocation: the engine already measures, per
(token-chunk, layer), how much attention mass the chunk carries
(``sparse/mask.block_scores`` pooled into ``WorkloadChunks.
active_blocks``) and how information-dense its quantized KV is
(``huffman.entropy_bits`` -> ``WorkloadChunks.entropy_bits``). This
module turns those two signals into a per-chunk bit-width plan:

  saliency  s(t, l, h) = attention-mass share x entropy factor
  schedule  a declarative list of quantile-band rules mapping saliency
            rank -> ladder shift (finer for hot chunks, coarser for
            cold), every output snapped to ``BITRATE_LEVELS``.

Schedules are recipe-style: a schedule is data (name + rules), not
code, so fleets select one by name (``SparKVConfig.alloc_schedule``)
and new allocation policies are new table rows. The ``"uniform"``
schedule is the arming sentinel — with it, nothing per-chunk is built
anywhere in the stack and every trace is bit-identical to pre-PR runs;
``"flat"`` arms the per-chunk accounting (saliency-weighted quality,
per-chunk keys) while still allocating the base width everywhere, so
uniform-allocation fleets stay byte-identical on the wire.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compression.quantize import BITRATE_LEVELS, snap_to_ladder


@dataclasses.dataclass(frozen=True)
class AllocationRule:
    """One band of the saliency spectrum: chunks whose saliency
    *quantile rank* falls in [lo_q, hi_q) move ``delta`` rungs along
    ``BITRATE_LEVELS`` from the base width (positive = finer = more
    bits). Bands may not overlap within a schedule; unbanded ranks keep
    the base width."""
    lo_q: float
    hi_q: float
    delta: int

    def __post_init__(self):
        assert 0.0 <= self.lo_q < self.hi_q <= 1.0, (self.lo_q, self.hi_q)


@dataclasses.dataclass(frozen=True)
class AllocationSchedule:
    """Declarative per-chunk bit-allocation recipe (see module doc)."""
    name: str
    rules: tuple = ()

    def __post_init__(self):
        spans = sorted((r.lo_q, r.hi_q) for r in self.rules)
        for (_, hi), (lo, _) in zip(spans, spans[1:]):
            assert hi <= lo, f"{self.name}: overlapping rule bands"

    def shift_for_rank(self, rank: np.ndarray) -> np.ndarray:
        """Ladder shift per chunk from its saliency quantile rank."""
        shift = np.zeros(rank.shape, np.int64)
        for r in self.rules:
            hit = (rank >= r.lo_q) & (rank < r.hi_q)
            shift[hit] = r.delta
        return shift


def ladder_shift(bits: int, delta: int) -> int:
    """Move ``delta`` rungs along BITRATE_LEVELS from ``bits`` (snapped
    first); positive deltas go finer, clamped at the ladder ends."""
    idx = BITRATE_LEVELS.index(snap_to_ladder(bits))
    return BITRATE_LEVELS[int(np.clip(idx - delta, 0,
                                      len(BITRATE_LEVELS) - 1))]


# The recipe table. "uniform" = per-chunk machinery disarmed (sentinel);
# "flat" = armed but allocating base everywhere (byte-identical wire);
# "attention" = the paper-motivated default: the hottest 30% of chunks
# by saliency go one rung finer, the coldest 40% one rung coarser;
# "aggressive" = trade harder: coldest half two rungs down.
SCHEDULES: dict[str, AllocationSchedule] = {
    "uniform": AllocationSchedule("uniform"),
    "flat": AllocationSchedule("flat"),
    "attention": AllocationSchedule("attention", (
        AllocationRule(0.0, 0.4, -1),
        AllocationRule(0.7, 1.0, +1),
    )),
    "aggressive": AllocationSchedule("aggressive", (
        AllocationRule(0.0, 0.5, -2),
        AllocationRule(0.8, 1.0, +1),
    )),
}


def chunk_saliency(active_blocks: np.ndarray,
                   entropy_bits: np.ndarray) -> np.ndarray:
    """Per-chunk saliency from the two measured signals.

    ``active_blocks`` is (n_t, n_l, n_h) attention mass (blocks the
    sparse mask keeps); ``entropy_bits`` is (n_l, n_h) bits/value of the
    quantized KV. Saliency is the normalized attention-mass share scaled
    by a normalized entropy factor: a chunk matters when attention reads
    it a lot *and* its values carry information worth the bits. Output
    is (n_t, n_l, n_h), mean ~1, all entries > 0.
    """
    act = np.asarray(active_blocks, np.float64)
    ent = np.asarray(entropy_bits, np.float64)
    a = act / max(float(act.mean()), 1e-12)
    e = ent / max(float(ent.mean()), 1e-12) if float(ent.sum()) > 0 \
        else np.ones_like(ent)
    # entropy enters sub-linearly: attention mass is the primary signal
    # (Fig. 3's 15-20x spread), entropy tilts within it
    s = a * (0.5 + 0.5 * np.broadcast_to(e, act.shape))
    return np.maximum(s, 1e-9)


def saliency_ranks(saliency: np.ndarray) -> np.ndarray:
    """Quantile rank in [0, 1) of each chunk's saliency (stable order,
    ties broken by flat index so allocation is deterministic)."""
    flat = saliency.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty(flat.size, np.float64)
    rank[order] = np.arange(flat.size, dtype=np.float64) / flat.size
    return rank.reshape(saliency.shape)


def allocate_bits(active_blocks: np.ndarray, entropy_bits: np.ndarray,
                  base_bits: int, schedule: AllocationSchedule
                  ) -> np.ndarray:
    """Per-chunk bit-widths (same shape as ``active_blocks``, int64),
    every entry a ``BITRATE_LEVELS`` width. An empty-rule schedule
    returns the snapped base everywhere."""
    base = snap_to_ladder(base_bits)
    sal = chunk_saliency(active_blocks, entropy_bits)
    shift = schedule.shift_for_rank(saliency_ranks(sal))
    out = np.empty(shift.shape, np.int64)
    for d in np.unique(shift):
        out[shift == d] = ladder_shift(base, int(d))
    return out


def schedule_of(name: str) -> AllocationSchedule:
    if name not in SCHEDULES:
        raise KeyError(f"unknown allocation schedule {name!r}; "
                       f"have {sorted(SCHEDULES)}")
    return SCHEDULES[name]
