"""Plain PyTorch reference of ganon's flat-filter classify and build.

Written from ganon's documented semantics (pirovc/ganon, seqan3's
interleaved Bloom filter), independent of the program under test: it
imports nothing of it, reads its files with its own parsers and takes
from them only what it judges. It runs on whatever device its tensors
are on (the card after a benchmark run, the CPU in tests).

* Minimizers: dna4 ranks, forward and reverse-complement 2-bit k-mer
  values XORed with ``SEED64 >> (64 - 2k)``, the unsigned smaller one;
  each window of ``w - k + 1`` k-mers has its leftmost minimum, and a read
  emits one hash each time that position changes (the first window
  always). A target's hashes are its distinct window minima.
* Filter: a bit-matrix of ``bin_size`` rows by the technical bins; a
  target's sorted hashes fill consecutive bins of at most
  ``max_hashes_bin`` each; a hash sets row ``fastrange(mix_i(h))`` of its
  bin for each of the ``h`` hash functions.
* Classify: a read's count for a target is the number of (hash, bin of
  the target) whose every row bit is set, at most the read's hash count;
  the rel-cutoff, rel-filter and fpr-query thresholds, the per-read
  match order (count descending, target ascending), the EM
  reassignment and the abundance report follow.
"""

from __future__ import annotations

import json
import math
import zipfile

import numpy as np
import torch

from portbench.reference import sizing_ref

SEED64 = 0x8F3F73B5CF1C9ADE
GOLDEN = 0x9E3779B97F4A7C15
HASH_SEEDS = (13572355802537770549, 13043817825332782213,
              10650232656628343401, 16499269484942379435,
              4893150838803335377)
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def _i64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1) if s else x


# --------------------------------------------------------------------------
# minimizers


def kmer_canon(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mer values, int64 bit patterns ``[B, L - k + 1]``
    (positions past a read's end are left as computed: windows that
    reach them are never used)."""
    c = codes.to(torch.int64)
    nk = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], nk), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[:, j:j + nk]
        rev = rev | ((3 - c[:, j:j + nk]) << (2 * j))
    seed = _i64(SEED64 >> (64 - 2 * k))
    fwd = fwd ^ seed
    rev = rev ^ seed
    # unsigned minimum: compare with the sign bit flipped
    return torch.where((fwd ^ _SIGN) <= (rev ^ _SIGN), fwd, rev)


def window_minima(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                  w: int):
    """Per window: its minimum value, its leftmost argmin position and
    whether the window lies inside the read. ``[B, L - w + 1]`` each."""
    B, L = codes.shape
    if L < w:
        z = torch.zeros((B, 1), dtype=torch.int64, device=codes.device)
        return z, z, torch.zeros((B, 1), dtype=torch.bool,
                                 device=codes.device)
    canon = kmer_canon(codes, k) ^ _SIGN  # signed order == unsigned
    ww = w - k + 1
    win = canon.unfold(1, ww, 1)  # [B, nw, ww]
    rel = win.argmin(dim=2)
    nw = win.shape[1]
    start = torch.arange(nw, device=codes.device)
    pos = start[None, :] + rel
    val = torch.gather(canon, 1, pos) ^ _SIGN
    inside = start[None, :] + w <= lengths.to(torch.int64)[:, None]
    return val, pos, inside


def read_hashes(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    """The hashes a read emits, in order: ``(values [N], row [N])``, the
    row of each value's read."""
    val, pos, inside = window_minima(codes, lengths, k, w)
    emit = inside.clone()
    emit[:, 1:] &= pos[:, 1:] != pos[:, :-1]
    rows, cols = emit.nonzero(as_tuple=True)
    return val[rows, cols], rows


def distinct_hashes(codes_1d: torch.Tensor, k: int, w: int,
                    piece: int = 1 << 22) -> torch.Tensor:
    """Sorted distinct window minima of one sequence (int64 bit patterns,
    sorted as unsigned), in overlapping pieces to bound memory."""
    n = codes_1d.numel()
    parts = []
    for s in range(0, max(n - w + 1, 0), piece):
        seg = codes_1d[s:min(n, s + piece + w - 1)][None, :]
        val, _, inside = window_minima(
            seg, torch.tensor([seg.shape[1]], device=seg.device), k, w)
        parts.append(torch.unique(val[inside]))
    if not parts:
        return torch.empty(0, dtype=torch.int64, device=codes_1d.device)
    u = torch.unique(torch.cat(parts)) ^ _SIGN
    return torch.sort(u).values ^ _SIGN


# --------------------------------------------------------------------------
# hash family


def hash_rows(hashes: torch.Tensor, bin_size: int, i: int) -> torch.Tensor:
    """Row of hash function ``i`` in ``[0, bin_size)``."""
    if not 0 < bin_size < 1 << 31:
        raise ValueError("bin_size out of range")
    shift = 64 - bin_size.bit_length()
    g = hashes * _i64(HASH_SEEDS[i])
    g = g ^ _shr(g, shift)
    g = g * _i64(GOLDEN)
    hi, lo = _shr(g, 32), g & _M32
    return (hi * bin_size + ((lo * bin_size) >> 32)) >> 32


# --------------------------------------------------------------------------
# filter files (own parsers)


RAW_MAGIC = b"GANON-TPU-IBF-RAW1\n"


def read_filter(path: str):
    """(header dict, uint32 bit-matrix ``[bin_size, n_words]``) of a flat
    filter saved as the raw container or the npz."""
    if zipfile.is_zipfile(path):
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            bits = np.asarray(z["bits"])
        return header, bits
    with open(path, "rb") as f:
        if f.read(len(RAW_MAGIC)) != RAW_MAGIC:
            raise ValueError(f"{path}: not a raw flat filter")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode())
        off = f.tell()
    off += -off % 4096
    bits = np.memmap(path, mode="r", dtype=np.dtype(header["bits_dtype"]),
                     offset=off, shape=tuple(header["bits_shape"]))
    return header, bits


class Layout:
    """A flat filter's targets, bins and sizes as the reference works them
    out: ``bin_lo``/``bin_hi`` (each target's technical bins, from its
    hash count and ``max_hashes_bin``), the bin size, hash functions,
    words a row and each target's false-positive rate."""

    def __init__(self, targets: list, counts: list, *, bin_size: int,
                 h: int, max_hashes_bin: int, k: int, w: int,
                 max_fp: float = 0.0, n_words: int = 0):
        self.targets = list(targets)
        self.counts = [int(c) for c in counts]
        self.bin_size, self.h = int(bin_size), int(h)
        self.max_hashes_bin = int(max_hashes_bin)
        self.k, self.w, self.max_fp = int(k), int(w), float(max_fp)
        lo, hi, fp, b = [], [], [], 0
        for c in self.counts:
            nb, per = split_bins(c, self.max_hashes_bin)
            lo.append(b)
            b += nb
            hi.append(b)
            one = (1 - math.exp(-self.h / (self.bin_size / per))) ** self.h \
                if per else 0.0
            fp.append(1.0 - (1.0 - one) ** nb)
        self.bin_lo, self.bin_hi, self.fpr = lo, hi, fp
        self.n_words = int(n_words) or -(-b // 64) * 2

    @classmethod
    def from_config(cls, targets: list, counts: list, fcfg: dict):
        """The layout a build at the configuration's settings (``max_fp``,
        ``mode``, ``hash_functions``, ``tpu_sizing``) must give these
        targets and hash counts."""
        s = sizing_ref.size_filter(
            counts, max_fp=float(fcfg["max_fp"]), mode=fcfg["mode"],
            hash_functions=int(fcfg["hash_functions"]),
            tune=fcfg["tpu_sizing"] == "auto")
        return cls(targets, counts, bin_size=s.bin_size, h=s.h,
                   max_hashes_bin=s.max_hashes_bin, k=fcfg["kmer_size"],
                   w=fcfg["window_size"], max_fp=s.max_fp,
                   n_words=s.n_words)

    def bin_map(self) -> list:
        return [[b, t] for t, lo, hi in zip(self.targets, self.bin_lo,
                                            self.bin_hi)
                for b in range(lo, hi)]

    def header_mismatch(self, header: dict, shape) -> dict:
        """Entries of a filter file's header (and its matrix's shape) that
        differ from this layout."""
        cfg = header["ibf_config"]
        out = {key: int(cfg.get(key) != want) for key, want in (
            ("bin_size_bits", self.bin_size), ("hash_functions", self.h),
            ("max_hashes_bin", self.max_hashes_bin),
            ("kmer_size", self.k), ("window_size", self.w),
            ("max_fp", self.max_fp))}
        out["shape"] = int(tuple(shape) != (self.bin_size, self.n_words))
        out["targets"] = int(list(header["targets"]) != self.targets)
        out["hashes_count"] = int([int(c) for c in header["hashes_count"]]
                                  != self.counts)
        out["bin_map"] = int([tuple(x) for x in header["bin_map"]]
                             != [tuple(x) for x in self.bin_map()])
        return out


def split_bins(count: int, max_hashes_bin: int):
    """(bins, hashes a bin) of a target of ``count`` distinct hashes."""
    nb = -(-count // max_hashes_bin)
    per = min(-(-count // nb), max_hashes_bin) if nb else 0
    return nb, per


def target_bits(hashes: torch.Tensor, bin_size: int, h: int,
                max_hashes_bin: int):
    """The set bits of one target's bins: ``(bin offset [N], row [N])``
    (bin offset counted from the target's first bin)."""
    nb, per = split_bins(hashes.numel(), max_hashes_bin)
    off = torch.arange(hashes.numel(), device=hashes.device) // max(per, 1)
    rows = torch.cat([hash_rows(hashes, bin_size, i) for i in range(h)])
    return off.repeat(h), rows


def build_matrix(target_hashes: list, layout: Layout,
                 device) -> torch.Tensor:
    """The whole bit-matrix, int64 words holding u32 values ``[bin_size,
    n_words]``, from each target's sorted distinct hashes."""
    n_words = layout.n_words
    bits = torch.zeros(layout.bin_size * n_words * 32, dtype=torch.bool,
                       device=device)
    for hs, lo in zip(target_hashes, layout.bin_lo):
        off, rows = target_bits(hs, layout.bin_size, layout.h,
                                layout.max_hashes_bin)
        bits[rows * (n_words * 32) + lo + off] = True
    return pack_bits(bits.view(layout.bin_size, n_words, 32))


def pack_bits(b: torch.Tensor, rows: int = 1 << 18) -> torch.Tensor:
    """bool ``[R, W, 32]`` -> int64 words ``[R, W]`` (bit ``i`` from
    ``b[..., i]``), a block of rows at a time."""
    wts = torch.tensor([1 << i for i in range(32)], dtype=torch.int64,
                       device=b.device)
    return torch.cat([(b[r:r + rows].to(torch.int64) * wts).sum(dim=-1)
                      for r in range(0, b.shape[0], rows)])


def as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding u32 values -> int32 of the same bits."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


def words_mismatch(words: np.ndarray, want: torch.Tensor,
                   rows_chunk: int = 1 << 20) -> int:
    """32-bit words of a file's uint32 matrix that differ from ``want``
    (int64 words holding u32 values), read in blocks of rows; every word
    when the shapes differ."""
    if tuple(words.shape) != tuple(want.shape):
        return max(int(np.prod(words.shape)), want.numel())
    bad = 0
    for r0 in range(0, words.shape[0], rows_chunk):
        blk = torch.from_numpy(np.ascontiguousarray(
            words[r0:r0 + rows_chunk]).view(np.int32)).to(want.device)
        bad += int(((blk.to(torch.int64) & _M32)
                    != want[r0:r0 + rows_chunk]).sum())
    return bad


# --------------------------------------------------------------------------
# classify


def fold_words(words: torch.Tensor) -> torch.Tensor:
    """The control's filter: rows ``r`` and ``r + ceil(R / 2)`` ORed into
    one, a filter of half the memory holding every inserted hash (its
    false-positive rate well above the configured one)."""
    R = words.shape[0]
    half = (R + 1) // 2
    out = words[:half].clone()
    out[:R - half] |= words[half:]
    return out


def flat_counts(words: torch.Tensor, layout: Layout, hashes: torch.Tensor,
                read_of: torch.Tensor, n_reads: int, *, fold: bool = False,
                chunk: int = 1 << 18) -> torch.Tensor:
    """int32 ``[n_reads, T]``: each read's hit count a target (before the
    clamp to its hash count). ``words``: int32 ``[bin_size, n_words]`` on
    the device; ``fold`` reads it as :func:`fold_words` made it."""
    dev = words.device
    T = len(layout.targets)
    tgt_of_bin = torch.full((words.shape[1] * 32,), T, dtype=torch.int64,
                            device=dev)
    for t, (lo, hi) in enumerate(zip(layout.bin_lo, layout.bin_hi)):
        tgt_of_bin[lo:hi] = t
    counts = torch.zeros((n_reads * (T + 1),), dtype=torch.int32, device=dev)
    rows_of = words.shape[0]
    bit = torch.arange(32, device=dev, dtype=torch.int64)
    for c0 in range(0, hashes.numel(), chunk):
        hs = hashes[c0:c0 + chunk]
        acc = None
        for i in range(layout.h):
            r = hash_rows(hs, layout.bin_size, i)
            if fold:
                r = r % rows_of
            g = words[r]
            acc = g if acc is None else acc & g
        hi_, wi = acc.nonzero(as_tuple=True)
        v = acc[hi_, wi].to(torch.int64) & _M32
        p, b = (((v[:, None] >> bit) & 1) == 1).nonzero(as_tuple=True)
        tg = tgt_of_bin[wi[p] * 32 + b]
        rd = read_of[c0:c0 + chunk][hi_[p]]
        counts.index_add_(0, rd * (T + 1) + tg,
                          torch.ones_like(tg, dtype=torch.int32))
    return counts.view(n_reads, T + 1)[:, :T].contiguous()


def fpr_query_min_count(n: int, p: float, fpr_query: float) -> int:
    """Least count whose binomial upper tail, 1 - cdf(count; n, p), is at
    most ``fpr_query`` (ganon's sequential subtraction from 1)."""
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return 0 if fpr_query >= 1.0 else n
    q = 1.0
    lp, l1p, lgn = math.log(p), math.log(1.0 - p), math.lgamma(n + 1)
    for i in range(n + 1):
        q -= math.exp(lgn - math.lgamma(n - i + 1) - math.lgamma(i + 1)
                      + i * lp + (n - i) * l1p)
        if q <= fpr_query:
            return i
    return n + 1


def select_matches(counts: torch.Tensor, n_hashes: torch.Tensor,
                   fpr: list, *, rel_cutoff: float, rel_filter: float,
                   fpr_query: float, hashes_limit: int = 65535):
    """Per read the kept matches, ordered by count descending then target
    ascending: ``(read [M], target [M], count [M])`` on the host, reads
    ascending. ``counts`` ``[R, T]`` before the clamp."""
    n = n_hashes.to(torch.int64)
    c = torch.minimum(counts.to(torch.int64), n[:, None])
    nf = n.to(torch.float64)
    cutoff = torch.clamp(torch.ceil(nf * rel_cutoff), min=1.0).to(torch.int64)
    valid = (n > 0) & (n <= hashes_limit)
    kept = (c >= cutoff[:, None]) & valid[:, None]
    mx = torch.where(kept, c, 0).max(dim=1).values
    big = torch.iinfo(torch.int64).max
    mn = torch.minimum(n, torch.where(kept, c, big).min(dim=1).values)
    thr = (mx.to(torch.float64)
           - torch.ceil((mx - mn).to(torch.float64) * rel_filter)
           ).to(torch.int64)
    final = kept & (c >= thr[:, None])
    r, t = final.nonzero(as_tuple=True)
    v = c[r, t]
    r, t, v, nr = (x.cpu().numpy() for x in (r, t, v, n[r]))
    if fpr_query < 1.0 and len(r):
        cache: dict = {}
        keep = np.empty(len(r), dtype=bool)
        for j, (nn, tt, vv) in enumerate(zip(nr.tolist(), t.tolist(),
                                             v.tolist())):
            key = (nn, tt)
            m = cache.get(key)
            if m is None:
                m = cache[key] = fpr_query_min_count(nn, fpr[tt], fpr_query)
            keep[j] = vv >= m
        r, t, v = r[keep], t[keep], v[keep]
    order = np.lexsort((t, -v, r))
    return r[order], t[order], v[order]


# --------------------------------------------------------------------------
# EM reassignment and the report


def em_reassign(r: np.ndarray, t: np.ndarray, n_targets: int,
                max_iter: int = 10, threshold: float = 0.0):
    """ganon's EM over each read's ordered matches: probabilities start
    from unique-match counts; each round every multi-matching read goes to
    the first of its targets of highest probability, and the
    probabilities become the reassigned counts over the reads. Returns the
    last round's reassigned counts ``[T]``."""
    if not len(r):
        return np.zeros(n_targets, np.int64)
    first = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    seg_len = np.diff(np.r_[first, len(r)])
    multi = seg_len > 1
    seg_of = np.repeat(np.arange(len(first)), seg_len)
    base = np.bincount(t[first[~multi]], minlength=n_targets)
    prob = base / max(int(base.sum()), 1)
    it = 0
    while True:
        pm = prob[t]
        best = np.maximum.reduceat(pm, first)
        cand = np.where(pm == best[seg_of], np.arange(len(t)), len(t))
        win = np.minimum.reduceat(cand, first)
        reassigned = base + np.bincount(t[win[multi]], minlength=n_targets)
        new = reassigned / len(first)
        diff = float(np.abs(prob - new).sum())
        prob = new
        if diff <= threshold or (max_iter > 0 and it == max_iter - 1):
            return reassigned
        it += 1


def rep_rows(r, t, reassigned, targets, tax_rows, label="H1"):
    """The reassigned ``.rep`` body: ``{target: (direct, unique, shared,
    rank, name)}`` for every target with a match."""
    direct = np.bincount(t, minlength=len(targets))
    first = np.flatnonzero(np.r_[True, r[1:] != r[:-1]]) if len(r) else r
    seg_len = np.diff(np.r_[first, len(r)]) if len(r) else r
    unique = np.bincount(t[first[seg_len == 1]], minlength=len(targets)) \
        if len(r) else direct
    out = {}
    for j in np.flatnonzero(direct):
        name = targets[j]
        _, rank, tname, _ = tax_rows[name]
        out[name] = (int(direct[j]), int(unique[j]),
                     int(reassigned[j]) - int(unique[j]), rank, tname)
    return out


RANKS = ["root", "domain", "phylum", "class", "order", "family", "genus",
         "species", "assembly"]


def abundance_report(rep: dict, classified: int, unclassified: int,
                     tax_rows: dict) -> dict:
    """ganon's default report (abundance, the default ranks) of a
    reassigned ``.rep`` whose targets are leaves: ``{node: (rank, lineage,
    name, unique, shared, children, cum_count, percent)}`` (the lineage
    one slot a rank up to the node's, empty where it has none) plus the
    unclassified row under ``"-"``. ``tax_rows``: ``{node: (parent, rank, name,
    genome size)}``."""
    total = classified + unclassified

    def lineage(node):
        out = [node]
        while tax_rows[node][0] != node and node != "1":
            node = tax_rows[node][0]
            out.append(node)
        return out[::-1]

    def rank(node):
        return "root" if node == "1" else tax_rows[node][1]

    counts = {tg: u + s for tg, (_, u, s, _, _) in rep.items() if u + s}
    cum: dict = {}
    for tg, c in counts.items():
        for n in lineage(tg):
            cum[n] = cum.get(n, 0) + c
    ratio: dict = {}
    ranked: dict = {}
    for tg, c in counts.items():
        rk = rank(tg)
        ratio[rk] = ratio.get(rk, 0) + c / tax_rows[tg][3]
        ranked[rk] = ranked.get(rk, 0) + c
    corr = {tg: ranked[rank(tg)] * ((c / tax_rows[tg][3]) / ratio[rank(tg)])
            for tg, c in counts.items()}
    ccum: dict = {}
    for tg, c in corr.items():
        for n in lineage(tg):
            ccum[n] = ccum.get(n, 0) + c
    out = {"-": ("unclassified", "-", "unclassified", 0, 0, 0,
                 unclassified, unclassified / total * 100)}
    for node, cc in cum.items():
        rk = rank(node)
        if rk not in RANKS:
            continue
        u = s = 0
        if node in rep:
            u, s = rep[node][1], rep[node][2]
        by_rank = {rank(n): n for n in lineage(node)}
        lin = [by_rank.get(x, "") for x in RANKS[:RANKS.index(rk) + 1]]
        name = "root" if node == "1" else tax_rows[node][2]
        out[node] = (rk, "|".join(lin), name, u, s, cc - u - s, cc,
                     ccum[node] / total * 100)
    return out
