"""Tiny TSP solvers for latent-distance-constrained pairing (counterpart:
``pcgmix_tpu/augment/tsp.py``, of which this is a copy).

The reference uses ``tsp_solver.greedy.solve_tsp`` and
``python_tsp.heuristics.solve_tsp_local_search`` over 32×32-ish matrices
(augmentations.py:420-427, :483-493).  Neither package ships in this image;
batch-size-scale TSP is trivial host work, so we implement:

- :func:`solve_tsp_greedy` — nearest-neighbour construction + closing the
  tour (functional replacement for tsp_solver's greedy path with fixed
  endpoints (0, 0));
- :func:`solve_tsp_local_search` — 2-opt improvement seeded by an initial
  permutation (functional replacement for python_tsp's local search; the
  upstream one is stochastic, so only tour-quality equivalence is claimed).
"""

from __future__ import annotations

import numpy as np


def path_cost(dist: np.ndarray, path) -> float:
    return float(sum(dist[path[i], path[i + 1]] for i in range(len(path) - 1)))


def solve_tsp_greedy(dist: np.ndarray) -> list[int]:
    """Nearest-neighbour tour starting and ending at node 0.

    Returns a closed path [0, ..., 0] like the reference's
    ``solve_tsp(dist, endpoints=(0, 0))`` call sites expect."""
    n = dist.shape[0]
    if n == 1:
        return [0, 0]
    unvisited = set(range(1, n))
    path = [0]
    while unvisited:
        cur = path[-1]
        nxt = min(unvisited, key=lambda j: dist[cur, j])
        path.append(nxt)
        unvisited.remove(nxt)
    path.append(0)
    return path


def solve_tsp_local_search(
    dist: np.ndarray, x0: list[int], max_rounds: int = 50
) -> tuple[list[int], float]:
    """2-opt local search on an open permutation x0 (cycle implied).

    Mirrors the role of python_tsp's solve_tsp_local_search
    (augmentations.py:425): improve the greedy tour before pairing.
    """
    n = len(x0)
    tour = list(x0)
    if n < 4:
        return tour, path_cost(dist, tour + [tour[0]])

    def cycle_cost(t):
        return path_cost(dist, t + [t[0]])

    best = cycle_cost(tour)
    for _ in range(max_rounds):
        improved = False
        for i in range(1, n - 1):
            for j in range(i + 1, n):
                # reversing tour[i..j] swaps exactly two cycle edges —
                # O(1) delta instead of an O(n) candidate re-sum
                a, b = tour[i - 1], tour[i]
                c, e = tour[j], tour[(j + 1) % n]
                delta = dist[a][c] + dist[b][e] - dist[a][b] - dist[c][e]
                if delta >= 1e-9:
                    continue
                if delta > -1e-9:
                    # near-tie: fall back to the exact full-cost comparison
                    # so decisions match the pre-optimization behavior
                    cand = tour[:i] + tour[i : j + 1][::-1] + tour[j + 1 :]
                    cc = cycle_cost(cand)
                    if not cc < best - 1e-12:
                        continue
                tour[i : j + 1] = tour[i : j + 1][::-1]
                best = cycle_cost(tour)
                improved = True
        if not improved:
            break
    return tour, best
