"""KV chunk index space and the Transformer dependency structure (Fig. 7).

A chunk is c = (t, l, h): token-block t in [0, T), layer l in [0, L),
head h in [0, H). Two scheduler granularities (DESIGN.md §2):

  mode="paper":  both paths schedule (t, l, h) — the paper's Eq. 2-5 exactly.
  mode="engine": compute units are (t, l) (a layer physically advances all
                 heads at once); streaming stays per-head. Internally the
                 engine grid uses H=1 with per-head costs aggregated.

Dependency rules for *computing* chunk (t, l):
  token dep  : t == 0 or l == L-1  -> free; else (t-1, l) present
               (streamed or computed — induction gives all t' < t present).
  layer dep  : l == 0 -> free; else (t, l-1) locally *computed*
               (the hidden state Y_{l-1}^t only exists on the compute path).
Layer L-1 is a pure projection of Y_{L-2}^t (no horizontal dep).
Streaming a chunk has no dependencies.
"""
from __future__ import annotations

import dataclasses
import hashlib
from enum import IntEnum
from typing import Iterable, NamedTuple, Optional

import numpy as np


class Chunk(NamedTuple):
    t: int
    l: int  # noqa: E741
    h: int

    def __repr__(self):
        return f"c({self.t},{self.l},{self.h})"


class State(IntEnum):
    PENDING = 0
    STREAMED = 1
    COMPUTED = 2


# ---------------------------------------------------------------------------
# Content-addressed chunk identity (cross-request KV reuse)
# ---------------------------------------------------------------------------
#
# With causal attention the KV of token-block t depends only on the prefix
# up to and including t, so two requests share chunk (t, l) KV exactly when
# their token prefixes through block t are identical. Callers therefore
# feed a *prefix-closed* span id: the id of block t must encode the whole
# prefix 0..t (a hash chain — see repro.serving.traffic), not just block
# t's own tokens. The per-chunk content key further binds the model, the
# quantization width and the chunking, because a stored bitstream is only
# reusable for a byte-identical decode: the same token span encoded at
# different bits (or split at a different chunk_tokens) is a different
# artifact and must hash to a distinct key.


def span_content_id(token_bytes: bytes, prev_id: int = 0) -> int:
    """Prefix-closed content id of one token block: hash of the block's
    raw token bytes chained with the id of the preceding block. Stable
    across processes (blake2b, not Python's salted hash)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(prev_id.to_bytes(8, "little", signed=False))
    h.update(token_bytes)
    return int.from_bytes(h.digest(), "little")


def chunk_content_key(span_id: int, layer: int, *, model: str, bits: int,
                      chunk_tokens: int, head: int = 0) -> int:
    """Stable 64-bit content key of one KV chunk artifact: the
    prefix-closed token-span id plus everything that shapes the encoded
    bytes (model config, quantization bits, chunking, head). Equal keys
    <=> byte-identical reusable artifacts."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(span_id).to_bytes(8, "little", signed=False))
    for v in (layer, head, bits, chunk_tokens):
        h.update(int(v).to_bytes(4, "little", signed=True))
    h.update(model.encode())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class ChunkGrid:
    n_t: int
    n_l: int
    n_h: int = 1

    def __post_init__(self):
        assert self.n_t >= 1 and self.n_l >= 1 and self.n_h >= 1

    @property
    def size(self) -> int:
        return self.n_t * self.n_l * self.n_h

    def chunks(self) -> Iterable[Chunk]:
        for t in range(self.n_t):
            for l in range(self.n_l):
                for h in range(self.n_h):
                    yield Chunk(t, l, h)

    def index(self, c: Chunk) -> int:
        return (c.t * self.n_l + c.l) * self.n_h + c.h

    # ---- dependencies ----
    def token_pred(self, c: Chunk) -> Optional[Chunk]:
        """Predecessor whose presence (any path) gates compute; None if free."""
        if c.t == 0 or c.l == self.n_l - 1:
            return None
        return Chunk(c.t - 1, c.l, c.h)

    def layer_pred(self, c: Chunk) -> Optional[Chunk]:
        """Predecessor that must be *computed*; None if free."""
        if c.l == 0:
            return None
        return Chunk(c.t, c.l - 1, c.h)

    def compute_ready(self, c: Chunk, state: np.ndarray) -> bool:
        """state: int array indexed by self.index, values from State."""
        tp = self.token_pred(c)
        if tp is not None and state[self.index(tp)] == State.PENDING:
            return False
        lp = self.layer_pred(c)
        if lp is not None and state[self.index(lp)] != State.COMPUTED:
            return False
        return True

    def enabled_by_stream(self, c: Chunk, state: np.ndarray) -> list[Chunk]:
        """A_s(c): chunks newly compute-ready if c is streamed now."""
        out = []
        # streaming c can only satisfy the token dep of (t+1, l, h)
        if c.t + 1 < self.n_t and c.l < self.n_l - 1:
            succ = Chunk(c.t + 1, c.l, c.h)
            if state[self.index(succ)] == State.PENDING:
                lp = self.layer_pred(succ)
                if lp is None or state[self.index(lp)] == State.COMPUTED:
                    out.append(succ)
        return out

    def enabled_by_compute(self, c: Chunk, state: np.ndarray) -> list[Chunk]:
        """A_c(c): chunks newly compute-ready if c is computed now."""
        out = self.enabled_by_stream(c, state)  # token dep, same successor
        # computing c can satisfy the layer dep of (t, l+1, h)
        if c.l + 1 < self.n_l:
            succ = Chunk(c.t, c.l + 1, c.h)
            if state[self.index(succ)] == State.PENDING:
                tp = self.token_pred(succ)
                if tp is None or state[self.index(tp)] != State.PENDING:
                    out.append(succ)
        return out

    def initial_ready(self) -> list[Chunk]:
        """Only (t=0, l=0, h) are compute-ready at the start (paper §IV-B)."""
        return [Chunk(0, 0, h) for h in range(self.n_h)]

    def validate_schedule(self, events: list[tuple[Chunk, bool]]) -> bool:
        """events: ordered (chunk, is_compute). True iff dependency-legal
        and every chunk processed exactly once."""
        state = np.zeros(self.size, np.int8)
        for c, is_comp in events:
            i = self.index(c)
            if state[i] != State.PENDING:
                return False
            if is_comp and not self.compute_ready(c, state):
                return False
            state[i] = State.COMPUTED if is_comp else State.STREAMED
        return bool((state != State.PENDING).all())
