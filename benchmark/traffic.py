"""The one generator of the benchmark's traffic: it reads a mix's data file
(``benchmark/traffic/<mix>.json``) and makes, from ``--seed``, what the
cell's window sends.

- A serve mix (``"kind": "serve"``) is a closed loop of requests to one
  endpoint of the server.  Each request is a test set as SCaSML_GP's
  harnesses draw one: ``test_domain`` interior points uniform on the domain
  [-r, r]^d x [t0, T), then ``test_boundary`` points on the lateral
  boundary (``sample``).  The stream cycles through a pool of
  ``test_sets`` such sets, in a fresh seeded order each cycle, so every
  seed sends the same sizes.
- A train mix (``"kind": "train"``) trains one GP per step on one seeded
  collocation set, cycling the kernel candidates ridge_scales x
  gamma_scales from a seeded start.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any whole
    number)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def sample(rng: np.random.Generator, n_dom: int, n_bdy: int, dim: int, radius: float,
           t0: float, T: float) -> np.ndarray:
    """(n_dom + n_bdy, dim + 1) float32: interior points uniform on the
    domain, then boundary points uniform on a uniformly chosen facet of the
    lateral boundary, uniform in time (SCaSML_GP's ``sample_boundary``)."""
    n = n_dom + n_bdy
    pts = np.empty((n, dim + 1), np.float32)
    pts[:, :-1] = rng.uniform(-radius, radius, (n, dim))
    pts[:, -1] = rng.uniform(t0, T, n)
    facet = rng.integers(0, dim, n_bdy)
    pts[n_dom + np.arange(n_bdy), facet] = np.where(rng.random(n_bdy) < 0.5, radius, -radius)
    return pts


class Requests:
    """The request stream of a serve mix: ``points(i)`` for request
    i = 0, 1, ..., each a view into the pool of test sets."""

    def __init__(self, mix: dict, seed: int, dim: int, radius: float, t0: float, T: float):
        n_dom, n_bdy = int(mix["test_domain"]), int(mix["test_boundary"])
        rng = np.random.default_rng(sub_seed(seed, "pool"))
        self.pool = np.stack([sample(rng, n_dom, n_bdy, dim, radius, t0, T)
                              for _ in range(int(mix["test_sets"]))])
        self.rows = n_dom + n_bdy
        self._rng = np.random.default_rng(sub_seed(seed, "requests"))
        self._order: List[int] = []

    def points(self, i: int) -> np.ndarray:
        """(rows, d + 1) float32."""
        while len(self._order) <= i:
            self._order.extend(int(k) for k in self._rng.permutation(len(self.pool)))
        return self.pool[self._order[i]]


def train_candidates(mix: dict, seed: int) -> list:
    """[(ridge_scale, gamma_scale), ...] of the grid, rotated to a seeded
    start; the window cycles through it."""
    grid = [(float(r), float(g)) for r in mix["ridge_scales"] for g in mix["gamma_scales"]]
    start = sub_seed(seed, "candidates") % len(grid)
    return grid[start:] + grid[:start]


def pick(n_done: int, k: int, seed: int, tag: str) -> list:
    """k distinct indices below n_done, drawn from the seed, ascending."""
    rng = np.random.default_rng(sub_seed(seed, tag))
    return sorted(int(i) for i in rng.choice(n_done, size=min(k, n_done), replace=False))


class Reservoir:
    """A uniform sample of k of the items offered, drawn from the seed
    (Algorithm R): it keeps k items whatever the number offered, so a window
    keeps no more than the check reads."""

    def __init__(self, k: int, seed: int, tag: str):
        self.k, self.items, self.seen = int(k), [], 0
        self._rng = np.random.default_rng(sub_seed(seed, tag))
        self._u = self._rng.random(1 << 16)

    def offer(self, item) -> None:
        c = self.seen
        self.seen += 1
        if c < self.k:
            self.items.append(item)
            return
        if c >= len(self._u):
            self._u = np.concatenate([self._u, self._rng.random(len(self._u))])
        r = int(self._u[c] * (c + 1))
        if r < self.k:
            self.items[r] = item
