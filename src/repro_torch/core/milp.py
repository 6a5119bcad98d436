"""Exact MILP oracle for chunk scheduling (paper Eq. 1-5) via in-repo
branch & bound over the LP relaxation (core.lp simplex).

Variable layout (n = 2*C*K + K):
    x_trans[c,k] = v[c*K + k]
    x_comp[c,k]  = v[C*K + c*K + k]
    M[k]         = v[2*C*K + k]      (stage makespans)
Objective: sum_k M_k  (Eq. 1, linearized max via two >= constraints).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.core.chunks import ChunkGrid
from repro_torch.core.lp import solve_lp
from repro_torch.core.scheduler import Schedule, Stage


@dataclasses.dataclass
class MILPProblem:
    grid: ChunkGrid
    t_stream: np.ndarray
    t_comp: np.ndarray
    n_stages: int

    def __post_init__(self):
        self.C = self.grid.size
        self.K = self.n_stages
        self.nbin = 2 * self.C * self.K
        self.n = self.nbin + self.K
        self.chunk_list = list(self.grid.chunks())

    # ---- variable indexing ----
    def ix_t(self, ci: int, k: int) -> int:
        return ci * self.K + k

    def ix_c(self, ci: int, k: int) -> int:
        return self.C * self.K + ci * self.K + k

    def ix_m(self, k: int) -> int:
        return self.nbin + k

    def build(self):
        C, K, n = self.C, self.K, self.n
        g = self.grid
        obj = np.zeros(n)
        obj[self.nbin:] = 1.0

        A_eq, b_eq, A_ub, b_ub = [], [], [], []
        # (2) each chunk processed exactly once
        for ci in range(C):
            row = np.zeros(n)
            for k in range(K):
                row[self.ix_t(ci, k)] = 1.0
                row[self.ix_c(ci, k)] = 1.0
            A_eq.append(row)
            b_eq.append(1.0)
        # (1) linearized stage makespans
        for k in range(K):
            row_s = np.zeros(n)
            row_c = np.zeros(n)
            for ci in range(C):
                row_s[self.ix_t(ci, k)] = self.t_stream[ci]
                row_c[self.ix_c(ci, k)] = self.t_comp[ci]
            row_s[self.ix_m(k)] = -1.0
            row_c[self.ix_m(k)] = -1.0
            A_ub += [row_s, row_c]
            b_ub += [0.0, 0.0]
        # (3)-(5) readiness
        for ci, c in enumerate(self.chunk_list):
            tp = g.token_pred(c)
            lp_ = g.layer_pred(c)
            for k in range(K):
                if tp is not None:
                    pi = g.index(tp)
                    row = np.zeros(n)
                    row[self.ix_c(ci, k)] = 1.0
                    for kk in range(k + 1):
                        row[self.ix_t(pi, kk)] -= 1.0
                        row[self.ix_c(pi, kk)] -= 1.0
                    A_ub.append(row)
                    b_ub.append(0.0)
                if lp_ is not None:
                    qi = g.index(lp_)
                    row = np.zeros(n)
                    row[self.ix_c(ci, k)] = 1.0
                    for kk in range(k + 1):
                        row[self.ix_c(qi, kk)] -= 1.0
                    A_ub.append(row)
                    b_ub.append(0.0)
        # binaries <= 1
        for j in range(self.nbin):
            row = np.zeros(n)
            row[j] = 1.0
            A_ub.append(row)
            b_ub.append(1.0)
        return obj, np.array(A_ub), np.array(b_ub), \
            np.array(A_eq), np.array(b_eq)

    # ---- objective of an integral assignment ----
    def objective(self, assign: dict[int, tuple[str, int]]) -> float:
        ms = np.zeros(self.K)
        mc = np.zeros(self.K)
        for ci, (path, k) in assign.items():
            if path == "s":
                ms[k] += self.t_stream[ci]
            else:
                mc[k] += self.t_comp[ci]
        return float(np.maximum(ms, mc).sum())

    def feasible(self, assign: dict[int, tuple[str, int]]) -> bool:
        g = self.grid
        for ci, c in enumerate(self.chunk_list):
            path, k = assign[ci]
            if path != "c":
                continue
            tp = g.token_pred(c)
            if tp is not None:
                pp, pk = assign[g.index(tp)]
                if pk > k:
                    return False
            lp_ = g.layer_pred(c)
            if lp_ is not None:
                qp, qk = assign[g.index(lp_)]
                if qp != "c" or qk > k:
                    return False
        return True

    def to_schedule(self, assign) -> Schedule:
        stages = [Stage() for _ in range(self.K)]
        for ci, (path, k) in assign.items():
            c = self.chunk_list[ci]
            if path == "s":
                stages[k].stream.append(c)
                stages[k].t_stream += self.t_stream[ci]
            else:
                stages[k].comp.append(c)
                stages[k].t_comp += self.t_comp[ci]
        for st in stages:
            st.comp.sort(key=lambda c: (c.t, c.l, c.h))
        return Schedule(stages=[s for s in stages
                                if s.comp or s.stream], grid=self.grid)


@dataclasses.dataclass
class BnBResult:
    status: str
    objective: float
    assign: Optional[dict]
    nodes: int
    lp_bound: float


def solve_bnb(prob: MILPProblem, *, incumbent: Optional[float] = None,
              max_nodes: int = 4000, tol: float = 1e-6) -> BnBResult:
    obj, A_ub, b_ub, A_eq, b_eq = prob.build()
    n = prob.n

    root = solve_lp(obj, A_ub, b_ub, A_eq, b_eq)
    if root.status != "optimal":
        return BnBResult("infeasible", np.inf, None, 1, np.inf)
    lp_bound = root.fun

    best_obj = np.inf if incumbent is None else incumbent
    best_assign = None
    nodes = 0
    # stack entries: (bound, fixes) where fixes: {var: 0/1}
    stack = [(root.fun, {})]

    while stack and nodes < max_nodes:
        stack.sort(key=lambda e: -e[0])          # explore best bound last
        bound, fixes = stack.pop()
        if bound >= best_obj - tol:
            continue
        nodes += 1
        # apply fixes as equality rows
        ae = [A_eq] if len(A_eq) else []
        be = [b_eq] if len(b_eq) else []
        fr = np.zeros((len(fixes), n))
        fb = np.zeros(len(fixes))
        for i, (j, v) in enumerate(fixes.items()):
            fr[i, j] = 1.0
            fb[i] = v
        Ae = np.vstack(ae + [fr]) if len(fixes) else A_eq
        Be = np.concatenate(be + [fb]) if len(fixes) else b_eq
        res = solve_lp(obj, A_ub, b_ub, Ae, Be)
        if res.status != "optimal" or res.fun >= best_obj - tol:
            continue
        xb = res.x[:prob.nbin]
        frac = np.abs(xb - np.round(xb))
        j = int(np.argmax(frac))
        if frac[j] < 1e-6:
            # integral
            assign = _extract_assign(prob, res.x)
            if assign is not None and prob.feasible(assign):
                val = prob.objective(assign)
                if val < best_obj:
                    best_obj, best_assign = val, assign
            continue
        for v in (0, 1):
            nf = dict(fixes)
            nf[j] = v
            stack.append((res.fun, nf))

    status = "optimal" if nodes < max_nodes else "node_limit"
    return BnBResult(status, best_obj, best_assign, nodes, lp_bound)


def _extract_assign(prob: MILPProblem, x) -> Optional[dict]:
    assign = {}
    for ci in range(prob.C):
        found = None
        for k in range(prob.K):
            if x[prob.ix_t(ci, k)] > 0.5:
                found = ("s", k)
            if x[prob.ix_c(ci, k)] > 0.5:
                found = ("c", k)
        if found is None:
            return None
        assign[ci] = found
    return assign


# ---------------------------------------------------------------------------
# Fleet-level LP relaxation (serving/scenarios.FleetRebalancer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetLP:
    """LP relaxation of the fleet placement problem — Eq. 1's
    stream-vs-compute makespan lifted from one request's chunks to the
    whole fleet's byte demands (the continuous relaxation the
    :class:`~repro.serving.scenarios.FleetRebalancer` re-solves at every
    handoff/outage/churn event).

    Variable layout (n = D*A + D + 1)::

        y[d,a] = v[d*A + a]       bytes device d streams via AP a
        c[d]   = v[D*A + d]       bytes device d prefills locally
        T      = v[D*A + D]       fleet makespan (the objective)

    Constraints: per-device demand conservation (every outstanding byte
    is either streamed through some reachable AP or computed locally),
    per-AP uplink capacity ``sum_d y[d,a] <= bw_a * T``, per-device
    compute capacity ``c_d <= rate_d * T``, and one reachability row per
    (d, a) pair — ``y[d,a] <= 0`` when unreachable, slack (bounded by
    total demand) when reachable, so the row layout is identical across
    solves whatever the reach sets and a previous solve's basis stays
    structurally valid as a warm start. Byte quantities are normalized
    by the peak demand so the simplex works on O(1) numbers whatever
    the context sizes.
    """
    demand: np.ndarray        # (D,) outstanding bytes per device
    ap_bw: np.ndarray         # (A,) effective uplink capacity, bytes/s
    comp_rate: np.ndarray     # (D,) local prefill throughput, bytes/s
    reach: list               # device -> iterable of reachable AP ids

    def __post_init__(self):
        self.demand = np.asarray(self.demand, float)
        self.ap_bw = np.asarray(self.ap_bw, float)
        self.comp_rate = np.asarray(self.comp_rate, float)
        self.D = len(self.demand)
        self.A = len(self.ap_bw)
        assert len(self.comp_rate) == self.D
        assert len(self.reach) == self.D
        self.n = self.D * self.A + self.D + 1
        self._scale = max(float(self.demand.max(initial=0.0)), 1.0)

    def ix_y(self, d: int, a: int) -> int:
        return d * self.A + a

    def ix_c(self, d: int) -> int:
        return self.D * self.A + d

    @property
    def ix_t(self) -> int:
        return self.D * self.A + self.D

    def build(self):
        D, A, n, s = self.D, self.A, self.n, self._scale
        obj = np.zeros(n)
        obj[self.ix_t] = 1.0
        A_eq, b_eq, A_ub, b_ub = [], [], [], []
        for d in range(D):                    # demand conservation
            row = np.zeros(n)
            for a in range(A):
                row[self.ix_y(d, a)] = 1.0
            row[self.ix_c(d)] = 1.0
            A_eq.append(row)
            b_eq.append(self.demand[d] / s)
        for a in range(A):                    # AP uplink capacity
            row = np.zeros(n)
            for d in range(D):
                row[self.ix_y(d, a)] = 1.0
            row[self.ix_t] = -max(self.ap_bw[a], 1e-9) / s
            A_ub.append(row)
            b_ub.append(0.0)
        for d in range(D):                    # local compute capacity
            row = np.zeros(n)
            row[self.ix_c(d)] = 1.0
            row[self.ix_t] = -max(self.comp_rate[d], 1e-9) / s
            A_ub.append(row)
            b_ub.append(0.0)
        tot = float(self.demand.sum()) / s    # slack bound, reachable rows
        for d in range(D):                    # reachability (fixed layout)
            ok = set(self.reach[d])
            for a in range(A):
                row = np.zeros(n)
                row[self.ix_y(d, a)] = 1.0
                A_ub.append(row)
                b_ub.append(tot if a in ok else 0.0)
        return obj, np.array(A_ub), np.array(b_ub), \
            np.array(A_eq), np.array(b_eq)

    def extract(self, x: np.ndarray) -> tuple[dict, np.ndarray, float]:
        """(placement device -> AP carrying its largest streamed share,
        per-device locally-computed fraction, makespan seconds).
        Zero-demand devices keep no placement entry — the caller leaves
        them where they are."""
        placement: dict[int, int] = {}
        local_frac = np.zeros(self.D)
        for d in range(self.D):
            if self.demand[d] <= 0:
                continue
            y = np.array([x[self.ix_y(d, a)] for a in range(self.A)])
            tot = y.sum() + x[self.ix_c(d)]
            if tot <= 0:
                continue
            local_frac[d] = float(x[self.ix_c(d)] / tot)
            if y.max() > 0:
                placement[d] = int(np.argmax(y))
        return placement, local_frac, float(x[self.ix_t])


def brute_force(prob: MILPProblem) -> tuple[float, Optional[dict]]:
    """Exhaustive search for unit tests (tiny instances only)."""
    C, K = prob.C, prob.K
    assert (2 * K) ** C <= 300_000, "instance too large for brute force"
    options = [("s", k) for k in range(K)] + [("c", k) for k in range(K)]
    best, best_assign = np.inf, None
    for combo in itertools.product(options, repeat=C):
        assign = dict(enumerate(combo))
        if not prob.feasible(assign):
            continue
        v = prob.objective(assign)
        if v < best:
            best, best_assign = v, assign
    return best, best_assign
