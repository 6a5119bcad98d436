"""Dense two-phase primal simplex (Bland's rule) — in-repo replacement for
an external LP solver, used by the branch & bound MILP oracle (core.milp).

    minimize c @ x
    s.t.     A_ub @ x <= b_ub
             A_eq @ x == b_eq
             0 <= x
Problem sizes here are a few hundred variables/rows; dense numpy is fine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LPResult:
    status: str                # optimal | infeasible | unbounded | maxiter
    x: Optional[np.ndarray]
    fun: float
    # final basic column set (slack columns included). Feed it back as
    # ``warm_basis`` on a structurally identical problem with perturbed
    # data — an event-to-event re-solve (the fleet rebalancer) then skips
    # phase 1 whenever the old basis is still primal-feasible.
    basis: Optional[np.ndarray] = None
    warm_used: bool = False    # True when the warm basis skipped phase 1


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int):
    T[row] /= T[row, col]
    for r in range(T.shape[0]):
        if r != row and T[r, col] != 0.0:
            T[r] -= T[r, col] * T[row]
    basis[row] = col


def _simplex_core(T: np.ndarray, basis: np.ndarray, n_real: int,
                  max_iter: int) -> str:
    """Minimize objective in last row of tableau T. Bland's rule."""
    m = T.shape[0] - 1
    for _ in range(max_iter):
        # entering: lowest index with negative reduced cost
        costs = T[-1, :-1]
        neg = np.nonzero(costs < -1e-9)[0]
        if len(neg) == 0:
            return "optimal"
        col = int(neg[0])
        ratios = np.full(m, np.inf)
        pos = T[:m, col] > 1e-9
        ratios[pos] = T[:m, -1][pos] / T[:m, col][pos]
        if not np.isfinite(ratios).any():
            return "unbounded"
        rmin = ratios.min()
        # leaving: among min ratio, lowest basis index (Bland)
        cand = np.nonzero(ratios <= rmin + 1e-12)[0]
        row = int(cand[np.argmin(basis[cand])])
        _pivot(T, basis, row, col)
    return "maxiter"


def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None,
             max_iter: int = 20000,
             warm_basis=None) -> LPResult:
    c = np.asarray(c, float)
    n = len(c)
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, float)
    b_ub = np.zeros(0) if b_ub is None else np.asarray(b_ub, float)
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, float)
    b_eq = np.zeros(0) if b_eq is None else np.asarray(b_eq, float)
    mu, me = len(b_ub), len(b_eq)
    m = mu + me

    # rows: [A_ub | I_slack ; A_eq | 0], then flip rows with b < 0
    A = np.zeros((m, n + mu))
    A[:mu, :n] = A_ub
    A[:mu, n:n + mu] = np.eye(mu)
    A[mu:, :n] = A_eq
    b = np.concatenate([b_ub, b_eq])
    for r in range(m):
        if b[r] < 0:
            A[r] *= -1
            b[r] *= -1

    # warm start: a prior run's basis on a structurally identical problem
    # (same row/column layout, perturbed data). When it is still primal
    # feasible — B nonsingular, B^{-1} b >= 0 — phase 1 is skipped and
    # phase 2 resumes from the old vertex; otherwise fall through to the
    # cold two-phase path (bit-identical results either way: both end at
    # an optimal vertex of the same LP).
    if warm_basis is not None and len(warm_basis) == m:
        wb = np.asarray(warm_basis, int)
        if np.all((wb >= 0) & (wb < n + mu)) and len(np.unique(wb)) == m:
            Bmat = A[:, wb]
            try:
                xb = np.linalg.solve(Bmat, b)
                rows = np.linalg.solve(Bmat, A)
            except np.linalg.LinAlgError:
                xb = None
            if xb is not None and np.all(xb >= -1e-9):
                T2 = np.zeros((m + 1, n + mu + 1))
                T2[:m, :n + mu] = rows
                T2[:m, -1] = np.maximum(xb, 0.0)
                basis = wb.copy()
                T2[-1, :n] = c
                for r in range(m):
                    bcol = basis[r]
                    if T2[-1, bcol] != 0.0:
                        T2[-1] -= T2[-1, bcol] * T2[r]
                st = _simplex_core(T2, basis, n, max_iter)
                if st == "optimal":
                    x = np.zeros(n + mu)
                    for r in range(m):
                        if basis[r] < n + mu:
                            x[basis[r]] = T2[r, -1]
                    return LPResult("optimal", x[:n], float(c @ x[:n]),
                                    basis=basis.copy(), warm_used=True)
                if st == "unbounded":
                    return LPResult(st, None, -np.inf)
                # maxiter from a warm vertex: retry cold below

    # basis: slack where possible, artificial otherwise
    basis = np.full(m, -1, int)
    art_cols = []
    for r in range(m):
        if r < mu and A[r, n + r] == 1.0:
            basis[r] = n + r
        else:
            art_cols.append(r)
    n_art = len(art_cols)
    Afull = np.hstack([A, np.zeros((m, n_art))])
    for i, r in enumerate(art_cols):
        Afull[r, n + mu + i] = 1.0
        basis[r] = n + mu + i
    ncols = n + mu + n_art

    # phase 1
    T = np.zeros((m + 1, ncols + 1))
    T[:m, :ncols] = Afull
    T[:m, -1] = b
    if n_art:
        T[-1, n + mu:ncols] = 1.0
        for r in art_cols:
            T[-1] -= T[r]
        st = _simplex_core(T, basis, n, max_iter)
        if st != "optimal" or T[-1, -1] < -1e-7:
            return LPResult("infeasible", None, np.inf)
        # drive artificials out of the basis if degenerate
        for r in range(m):
            if basis[r] >= n + mu:
                cand = np.nonzero(np.abs(T[r, :n + mu]) > 1e-9)[0]
                if len(cand):
                    _pivot(T, basis, r, int(cand[0]))

    # phase 2
    T2 = np.zeros((m + 1, n + mu + 1))
    T2[:m, :n + mu] = T[:m, :n + mu]
    T2[:m, -1] = T[:m, -1]
    T2[-1, :n] = c
    for r in range(m):
        bcol = basis[r]
        if bcol < n + mu and T2[-1, bcol] != 0.0:
            T2[-1] -= T2[-1, bcol] * T2[r]
    st = _simplex_core(T2, basis, n, max_iter)
    if st != "optimal":
        return LPResult(st, None, np.inf if st != "unbounded" else -np.inf)
    x = np.zeros(n + mu)
    for r in range(m):
        if basis[r] < n + mu:
            x[basis[r]] = T2[r, -1]
    return LPResult("optimal", x[:n], float(T2[-1, -1] * -1.0)
                    if False else float(c @ x[:n]), basis=basis.copy())
