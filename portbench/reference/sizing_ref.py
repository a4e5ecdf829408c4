"""The flat filter's size from the configuration, as the reference works
it out: the bin size, hash functions and hashes a bin that a build at a
configured ``max_fp`` and ``mode`` must choose for the given hash counts.

A frozen copy of ganon's sizing search (GanonBuild.cpp: the bin size at
a false-positive rate, the correction for split targets, the search over
hashes a bin every 100 from the largest target down, and the
mode-weighted pick) and of the port's documented ``--tpu-sizing auto``
re-size (fewer hash functions where its probe-cost model says they are
cheaper, within 6 GiB and 4x the memory of the first pick). Plain
arithmetic on the counts; it imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

MAX_H = 5
# the --tpu-sizing auto re-size: its cost model's table bands (bytes),
# and the most it may grow the table
U8_STAGED = 28 << 20
U32_STAGED = 96 << 20
MAX_TABLE = 6 << 30
MAX_GROWTH = 4.0


@dataclass
class Sizing:
    bin_size: int = 0
    h: int = 0
    max_hashes_bin: int = 0
    n_bins: int = 0
    max_fp: float = 0.0

    @property
    def n_words(self) -> int:
        """32-bit words a row: the bins padded to 64."""
        return -(-self.n_bins // 64) * 2


def bin_size_fp(fp: float, n: int) -> int:
    return math.ceil((n * math.log(fp)) / math.log(1.0 / 2 ** math.log(2)))


def bin_size_fp_hf(fp: float, n: int, h: int) -> int:
    return math.ceil(n * (-h / math.log(1 - math.exp(math.log(fp) / h))))


def false_positive(bin_size: int, h: int, n: int) -> float:
    return (1 - math.exp(-h / (bin_size / n))) ** h


def _pick_h(bin_size: int, n: int, h: int) -> int:
    if h == 0:
        h = int(math.log(2) * (bin_size / n))
    return MAX_H if h > MAX_H or h == 0 else h


def search(counts: list, max_fp: float, h: int, mode: str) -> Sizing:
    """ganon's search over hashes a bin (sized by ``max_fp``)."""
    top = max(counts, default=0)
    step = min(100, top)
    sims, min_size, min_bins = [], 0, 0
    n = top + 1
    while n > step:
        per = n - 1
        n_bins = sum(math.ceil(c / per) for c in counts)
        if h == 0:
            bs = bin_size_fp(max_fp, per)
            hf = _pick_h(bs, per, h)
        else:
            hf = _pick_h(0, per, h)
            bs = bin_size_fp_hf(max_fp, per, hf)
        split = math.ceil(top / per)
        approx = min(false_positive(bs, hf, math.ceil(top / split)), max_fp)
        target = 1.0 - math.exp(math.log(1.0 - approx) / split)
        crate = (bin_size_fp_hf(target, per, hf)
                 / bin_size_fp_hf(approx, per, hf))
        bs = int(bs * crate)
        size = bs * (-(-n_bins // 64) * 64)
        if size == 0 or math.isinf(crate):
            break
        if size < min_size or min_size == 0:
            min_size = size
        sims.append((per, n_bins, size))
        if n_bins < min_bins or min_bins == 0:
            min_bins = n_bins
        n -= step
    mv = {"smaller": 0.5, "faster": 0.5, "smallest": 0.0,
          "fastest": 0.0}.get(mode, 1.0)
    var_w = mv if mode in ("smaller", "smallest") else 1.0
    bins_w = mv if mode in ("faster", "fastest") else 1.0
    out, best = Sizing(max_fp=max_fp), 0.0
    for per, n_bins, size in sims:
        vr, br = size / min_size, n_bins / min_bins
        avg = (1 + mv ** 2) * ((vr * br) / (var_w * vr + bins_w * br))
        if avg < best or best == 0:
            best = avg
            out.bin_size = size // (-(-n_bins // 64) * 64)
            out.max_hashes_bin, out.n_bins = per, n_bins
            out.h = _pick_h(out.bin_size, per, h)
    return out


def _row_bytes(per: int, counts: list) -> int:
    """A query-table row that keeps each target's bins in whole bytes."""
    per = max(per, 1)
    total = 0
    for c in counts:
        if c:
            bins = -(-c // per)
            total += -(-bins // 8)
    return total


def _probe_ns(table: int, row: int) -> float:
    if table <= U8_STAGED:
        if row <= 128:
            return 2.0
        if row <= 256:
            return 2.3
        return 2.8 if row <= 512 else 2.8 * row / 512
    if table <= U32_STAGED:
        return 3.0 + 0.011 * row
    return 11.0 + 0.011 * row


def size_filter(counts: list, *, max_fp: float, mode: str,
                hash_functions: int, tune: bool) -> Sizing:
    """The sizing a build at these settings chooses: ganon's search, then
    (``tune``: ``--tpu-sizing auto`` with the hash functions left to the
    default) the re-size to fewer hash functions where cheaper."""
    s = search(counts, max_fp, hash_functions, mode)
    if not tune:
        return s

    def table(c: Sizing) -> int:
        return c.bin_size * _row_bytes(c.max_hashes_bin, counts)

    def cost(c: Sizing) -> float:
        row = max(_row_bytes(c.max_hashes_bin, counts), 1)
        return c.h * _probe_ns(c.bin_size * row, row)

    base, best, best_cost = table(s), None, cost(s)
    for h in range(1, s.h):
        c = search(counts, max_fp, h, mode)
        if c.n_bins == 0 or table(c) > MAX_TABLE \
                or table(c) > MAX_GROWTH * max(base, 1):
            continue
        if cost(c) < best_cost:
            best, best_cost = c, cost(c)
    return best or s
