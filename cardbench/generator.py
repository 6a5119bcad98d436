"""The one traffic generator: a workload file's parameters and a seed give
the contexts and the requests of a run.

Every seed gets the same work in another order: the requests are the
file's ``prompt_lengths`` taken in cycles, each cycle in an order drawn
from the seed, so that the lengths a window holds differ between seeds
only in its last, partial cycle. The planner's seed of a request is its
length's place in that list (1, 2, ...), so the planner draws the same
numbers for a length under every run seed. Token ids are uniform over
the vocabulary. Requests go round the contexts in turn.
"""
from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, workload: dict, vocab_size: int, seed: int):
        self.w = workload
        self.vocab = vocab_size
        self.seed = int(seed)
        rng = self._rng(0)
        self.contexts = [rng.integers(0, vocab_size,
                                      size=(1, workload["context_tokens"]))
                         for _ in range(workload["contexts"])]
        self.lengths = list(workload["prompt_lengths"])
        self.max_new = int(workload["max_new"])

    def _rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream])

    def kind(self, i: int) -> int:
        """Request i's place in ``prompt_lengths``."""
        cycle, at = divmod(i, len(self.lengths))
        return int(self._rng(1 + cycle).permutation(len(self.lengths))[at])

    def request(self, i: int) -> dict:
        """Request i of the window: its context index, prompt (int64) and
        planner seed."""
        k = self.kind(i)
        rng = self._rng(1_000_000 + i)
        return {"context": i % len(self.contexts),
                "prompt": rng.integers(0, self.vocab, size=self.lengths[k]),
                "plan_seed": k + 1}

    def warm_up(self) -> dict:
        """A request of the longest prompt, outside the window's."""
        k = self.lengths.index(max(self.lengths))
        rng = self._rng(999_999)
        return {"context": 0,
                "prompt": rng.integers(0, self.vocab, size=self.lengths[k]),
                "plan_seed": k + 1}
