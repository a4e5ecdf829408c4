"""Match thresholding math (host side, float64).

* ``threshold_rel``: ceil(n * p) — GanonClassify.cpp:492-495.
* ``binom_tail_q``: q = 1 - binomial_cdf(count; n, p), the probability of
  seeing more than ``count`` false-positive hash hits; a match is discarded
  when q > fpr_query — GanonClassify.cpp:588-601. Numerically sensitive:
  computed on host in float64 via lgamma, mirroring the reference's
  sequential subtraction from 1.
"""

from __future__ import annotations

import math

import numpy as np


def threshold_rel(n_hashes: int, p: float) -> int:
    return int(math.ceil(n_hashes * p))


def binom_tail_q(count: int, n_hashes: int, p: float) -> float:
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0 if count < n_hashes else 0.0
    q = 1.0
    lp = math.log(p)
    l1p = math.log(1.0 - p)
    lgn = math.lgamma(n_hashes + 1)
    for i in range(count + 1):
        q -= math.exp(
            lgn
            - math.lgamma(n_hashes - i + 1)
            - math.lgamma(i + 1)
            + i * lp
            + (n_hashes - i) * l1p
        )
    return q


def fpr_query_min_count(n_hashes: int, p: float, fpr_query: float) -> int:
    """Smallest count c with ``binom_tail_q(c, n_hashes, p) <= fpr_query``.

    ``binom_tail_q`` is monotone non-increasing in ``count`` — each extra
    count subtracts one more non-negative pmf term from the same partial
    sum — so the reference's per-match discard test ``q > fpr_query``
    (GanonClassify.cpp:588-601) is equivalent to ``count < min_count``.
    The loop below replicates binom_tail_q's sequential subtraction term
    for term, so decisions are bitwise identical to evaluating the tail
    per match. Returns ``n_hashes + 1`` when no count passes.
    """
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return 0 if fpr_query >= 1.0 else n_hashes
    q = 1.0
    lp = math.log(p)
    l1p = math.log(1.0 - p)
    lgn = math.lgamma(n_hashes + 1)
    for i in range(n_hashes + 1):
        q -= math.exp(
            lgn
            - math.lgamma(n_hashes - i + 1)
            - math.lgamma(i + 1)
            + i * lp
            + (n_hashes - i) * l1p
        )
        if q <= fpr_query:
            return i
    return n_hashes + 1


class FprQueryMinCount:
    """Vectorized fpr-query thresholding, cached per hierarchy level.

    One scalar ``min_count(n_hashes, target_fpr)`` per distinct pair
    replaces one binomial-tail evaluation per match; the filter becomes
    a plain ``counts >= min_count`` array comparison. The cache lives
    for the whole level (reads repeat lengths, targets repeat fprs).
    """

    def __init__(self, fpr_query: float):
        self.fpr_query = fpr_query
        self._cache: dict[tuple[int, float], int] = {}

    def min_count(self, n_hashes: int, p: float) -> int:
        key = (n_hashes, p)
        v = self._cache.get(key)
        if v is None:
            v = fpr_query_min_count(n_hashes, p, self.fpr_query)
            self._cache[key] = v
        return v

    def min_count_arr(self, ns: np.ndarray, ps: np.ndarray) -> np.ndarray:
        """Elementwise min_count over paired (n_hashes, fpr) arrays.

        The pair key packs into one complex128 (both halves exact: n is
        a small int, p a float64), so the dedup is a plain 1-D unique
        instead of the void-row axis=0 machinery — measurably cheaper
        in the host finish (scripts/e2e_host_profile.py).
        """
        key = np.asarray(ns, np.float64) + 1j * np.asarray(ps, np.float64)
        uniq, inv = np.unique(key, return_inverse=True)
        cm = np.fromiter(
            (self.min_count(int(k.real), float(k.imag)) for k in uniq),
            dtype=np.int64,
            count=len(uniq),
        )
        return cm[inv.reshape(-1)]


class BinomTailCache:
    """Memoized binom_tail_q (reads in a batch repeat (count, n, p))."""

    def __init__(self):
        self._cache: dict[tuple[int, int, float], float] = {}

    def q(self, count: int, n_hashes: int, p: float) -> float:
        key = (count, n_hashes, p)
        v = self._cache.get(key)
        if v is None:
            v = binom_tail_q(count, n_hashes, p)
            self._cache[key] = v
        return v
