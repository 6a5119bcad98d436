"""Potential-aware greedy KV chunk scheduler (paper §IV-B).

Priority scores combine immediate overhead with the compute potential the
chunk unlocks:

    w_s(c) = a/t_stream(c) + b * sum_{c' in A_s(c)} 1/t_comp(c')
    w_c(c) = a/t_comp(c)   + b * sum_{c' in A_c(c)} 1/t_comp(c')

Each stage has a time budget dt per path; the two paths run overlapped so
stage duration = max(path times). Local compute may chain within a stage
(computing a chunk can unlock its successors immediately); streamed chunks
land at the stage boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chunks import Chunk, ChunkGrid, State


@dataclasses.dataclass
class Stage:
    stream: list[Chunk] = dataclasses.field(default_factory=list)
    comp: list[Chunk] = dataclasses.field(default_factory=list)
    t_stream: float = 0.0
    t_comp: float = 0.0

    @property
    def makespan(self) -> float:
        return max(self.t_stream, self.t_comp)


@dataclasses.dataclass
class Schedule:
    stages: list[Stage]
    grid: ChunkGrid

    @property
    def makespan(self) -> float:
        return sum(s.makespan for s in self.stages)

    def n_computed(self) -> int:
        return sum(len(s.comp) for s in self.stages)

    def n_streamed(self) -> int:
        return sum(len(s.stream) for s in self.stages)

    def events(self) -> list[tuple[Chunk, bool]]:
        ev: list[tuple[Chunk, bool]] = []
        for s in self.stages:
            # within a stage computes happen (chained) before next-stage
            # consumers; streams land at the boundary
            ev.extend((c, True) for c in s.comp)
            ev.extend((c, False) for c in s.stream)
        return ev


class GreedyScheduler:
    def __init__(self, grid: ChunkGrid, t_stream: np.ndarray,
                 t_comp: np.ndarray, *, stage_budget_s: float = 0.25,
                 w_immediate: float = 1.0, w_potential: float = 1.0):
        """t_stream/t_comp: flat arrays indexed by grid.index."""
        self.grid = grid
        self.ts = np.asarray(t_stream, float)
        self.tc = np.asarray(t_comp, float)
        assert self.ts.shape == (grid.size,) == self.tc.shape
        self.dt = stage_budget_s
        self.a = w_immediate
        self.b = w_potential

    # ---- priority scores ----
    def w_stream(self, c: Chunk, state: np.ndarray) -> float:
        """Immediate + potential gain, minus the *opportunity cost* of
        streaming: once (t, l) is streamed, no chunk above it in column t
        can ever be computed (the layer dep needs a locally-computed
        hidden state), so streaming a low-layer chunk destroys the whole
        column's remaining compute potential. Without this term the greedy
        streams cheap low-layer chunks and starves the compute path (see
        EXPERIMENTS.md §Table-II notes)."""
        g = self.grid
        gain = sum(1.0 / self.tc[g.index(cc)]
                   for cc in g.enabled_by_stream(c, state))
        loss = 0.0
        for l2 in range(c.l + 1, g.n_l):
            i = g.index(Chunk(c.t, l2, c.h))
            if state[i] == State.PENDING:
                loss += 1.0 / self.tc[i]
        return (self.a / self.ts[self.grid.index(c)]
                + self.b * (gain - loss))

    def w_comp(self, c: Chunk, state: np.ndarray) -> float:
        gain = sum(1.0 / self.tc[self.grid.index(cc)]
                   for cc in self.grid.enabled_by_compute(c, state))
        return self.a / self.tc[self.grid.index(c)] + self.b * gain

    def run(self, max_stages: int = 10_000) -> Schedule:
        g = self.grid
        state = np.zeros(g.size, np.int8)
        pending = set(g.chunks())
        ready = {c for c in pending if g.compute_ready(c, state)}
        stages: list[Stage] = []

        while pending and len(stages) < max_stages:
            st = Stage()
            # --- compute phase (chains within the stage) ---
            # streamed chunks from earlier stages are already in `state`.
            while ready:
                best = max(ready, key=lambda c: self.w_comp(c, state))
                tbest = self.tc[g.index(best)]
                if st.t_comp + tbest > self.dt and st.comp:
                    break
                ready.discard(best)
                pending.discard(best)
                st.comp.append(best)
                st.t_comp += tbest
                state[g.index(best)] = State.COMPUTED
                for cc in (g.enabled_by_stream(best, state)
                           + g.enabled_by_compute(best, state)):
                    if cc in pending:
                        ready.add(cc)
                if st.t_comp >= self.dt:
                    break
            # --- stream phase ---
            cands = list(pending)
            cands.sort(key=lambda c: -self.w_stream(c, state))
            for c in cands:
                tc = self.ts[g.index(c)]
                if st.t_stream + tc > self.dt and st.stream:
                    break
                st.stream.append(c)
                st.t_stream += tc
                if st.t_stream >= self.dt:
                    break
            # commit streamed at the stage boundary
            for c in st.stream:
                pending.discard(c)
                ready.discard(c)
                state[g.index(c)] = State.STREAMED
            for c in st.stream:
                for cc in g.enabled_by_stream(c, state):
                    if cc in pending:
                        ready.add(cc)
            # refresh readiness (stream landings may enable chains)
            for c in list(pending):
                if c not in ready and g.compute_ready(c, state):
                    ready.add(c)
            if not st.comp and not st.stream:
                raise RuntimeError("scheduler stalled (no progress)")
            stages.append(st)
        return Schedule(stages=stages, grid=g)


def latency_only_greedy(grid: ChunkGrid, t_stream: np.ndarray,
                        t_comp: np.ndarray, **kw) -> Schedule:
    """Ablation: the naive latency-only policy (b = 0), paper §IV-B."""
    return GreedyScheduler(grid, t_stream, t_comp, w_potential=0.0,
                           **kw).run()


def positional_hybrid(grid: ChunkGrid, t_stream: np.ndarray,
                      t_comp: np.ndarray) -> Schedule:
    """'Strong Hybrid' baseline [25]: fixed positional split — early token
    columns computed bottom-up, later columns streamed, split chosen so
    profiled path times balance. One stage per token column (static)."""
    g = grid
    # cumulative compute time per column prefix vs stream time of the rest
    col_comp = np.zeros(g.n_t)
    col_stream = np.zeros(g.n_t)
    for c in g.chunks():
        col_comp[c.t] += t_comp[g.index(c)]
        col_stream[c.t] += t_stream[g.index(c)]
    best_split, best_cost = 0, float("inf")
    for split in range(g.n_t + 1):
        cost = max(col_comp[:split].sum(), col_stream[split:].sum())
        if cost < best_cost:
            best_cost, best_split = cost, split
    st = Stage()
    for c in g.chunks():
        if c.t < best_split:
            st.comp.append(c)
            st.t_comp += t_comp[g.index(c)]
        else:
            st.stream.append(c)
            st.t_stream += t_stream[g.index(c)]
    # order computes dependency-legally: by (t, l)
    st.comp.sort(key=lambda c: (c.t, c.l, c.h))
    return Schedule(stages=[st], grid=g)


def stream_only(grid: ChunkGrid, t_stream: np.ndarray,
                t_comp: np.ndarray) -> Schedule:
    st = Stage()
    st.stream = list(grid.chunks())
    st.t_stream = float(np.sum(t_stream))
    return Schedule(stages=[st], grid=grid)


def compute_only(grid: ChunkGrid, t_stream: np.ndarray,
                 t_comp: np.ndarray) -> Schedule:
    st = Stage()
    st.comp = sorted(grid.chunks(), key=lambda c: (c.t, c.l, c.h))
    st.t_comp = float(np.sum(t_comp))
    return Schedule(stages=[st], grid=grid)
