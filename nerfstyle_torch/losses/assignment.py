"""Linear sum assignment (counterpart of ``nerfstyle_tpu/losses/assignment.py``
and its native solver ``nerfstyle_tpu/native/hungarian.cpp``).

The semantic style loss matches render classes to style clusters once a run,
on a cost of a few rows by a few columns, so the port solves it in numpy and
plain Python: the shortest-augmenting-path Hungarian algorithm with row and
column potentials (O(n^2 m)), with ``scipy.optimize.linear_sum_assignment``'s
return convention.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _lsa_rows_le_cols(cost: np.ndarray) -> np.ndarray:
    """Column assigned to each row of a finite [n, m] cost with n <= m."""
    n, m = cost.shape
    u, v = np.zeros(n + 1), np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)  # p[j]: row matched to column j (1-based, 0 = none)
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], np.inf, 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j], way[j] = cur, j0
                if minv[j] < delta:
                    delta, j1 = minv[j], j
            if j1 == 0:
                raise ValueError("no finite augmenting path in the assignment cost")
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:  # flip the alternating path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.zeros(n, dtype=np.int64)
    for j in range(1, m + 1):
        if p[j] != 0:
            row_to_col[p[j] - 1] = j - 1
    return row_to_col


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost row -> column assignment of an [n, m] cost (non-finite
    entries are clipped to +-1e18); returns (row_indices, col_indices) as
    scipy does, ordered by row."""
    cost = np.nan_to_num(np.asarray(cost, dtype=np.float64), posinf=1e18, neginf=-1e18)
    if cost.ndim != 2:
        raise ValueError(f"the cost must be a matrix, got shape {cost.shape}")
    transposed = cost.shape[0] > cost.shape[1]
    work = cost.T if transposed else cost
    out = _lsa_rows_le_cols(np.ascontiguousarray(work))
    rows = np.arange(work.shape[0])
    if transposed:
        order = np.argsort(out)
        return out[order], rows[order]
    return rows, out
