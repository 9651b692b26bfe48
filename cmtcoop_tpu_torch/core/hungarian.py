"""Exact linear assignment on the host (counterpart of
cmtcoop_tpu/core/hungarian.py).

The JAX package solves each cost matrix on the TPU with a shortest
augmenting path loop inside `jit`. That loop is serial and data dependent:
on the card every Dijkstra step would be a host synchronisation. The port
does what the reference does (hungarian_assigner_3d.py:138-147): the costs
come to the host in one copy and scipy's `linear_sum_assignment` (the same
shortest-augmenting-path family, exact) solves the valid rows. On a cost
matrix without ties the optimum is unique, so the assignment equals the JAX
solver's.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

BIG = 1e9


def solve_lap(cost: np.ndarray, row_valid: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of the valid rows of `cost` (R, C), R <= C,
    to distinct columns. Returns col4row (R,) int64: the column of each
    valid row, -1 on invalid rows. NaN and infinite costs count as +-1e9,
    as in the JAX solver."""
    cost = np.asarray(cost, np.float64)
    if cost.shape[0] > cost.shape[1]:
        raise ValueError(f"need R <= C, got {cost.shape}")
    rows = np.flatnonzero(np.asarray(row_valid, bool))
    col4row = np.full(cost.shape[0], -1, np.int64)
    if rows.size:
        sub = np.nan_to_num(cost[rows], nan=BIG, posinf=BIG, neginf=-BIG)
        r, c = linear_sum_assignment(sub)
        col4row[rows[r]] = c
    return col4row
