"""The port's two-pass build against the JAX package's, on the CPU.

``DeviceBuildPipeline(device="cpu")`` runs the plain versions of the
build kernels (``ops/build_ops.py``); every case compares counts, the
filter's configuration and its bits with ``ganon_tpu``'s pipeline
(itself bit-identical to its host-array path), every plain kernel with
its JAX device program, and ``run_build`` / ``run_build_hibf`` with the
JAX package's files. Inputs are made from seeds with numpy.
"""

import gzip
import zlib

import numpy as np
import pytest
import torch

from ganon_tpu.index import sizing as jsizing
from ganon_tpu.index.device_build import CHUNK
from ganon_tpu.index.device_build import DeviceBuildPipeline as JaxPipeline
from ganon_tpu.ops.minimizers import encode_seqs
from ganon_tpu_torch.index import device_build as tdb
from ganon_tpu_torch.index import sizing as tsizing
from ganon_tpu_torch.ops import build_ops
from ganon_tpu_torch.ops.winnow import u64_to_torch

K, W = 19, 31
BASES = "ACGT"


def _random_seq(rng, n):
    return "".join(BASES[b] for b in rng.integers(0, 4, size=n))


def _mkinput(rng, n_targets=3, files_per_target=2, seqs_per_file=2,
             seq_len=4000):
    return {
        f"T{t}": [
            [_random_seq(rng, seq_len) for _ in range(seqs_per_file)]
            for _ in range(files_per_target)
        ]
        for t in range(n_targets)
    }


def _feed(pipe, seq_files):
    for target, files in seq_files.items():
        for fi, seqs in enumerate(files):
            for s in seqs:
                enc, _ = encode_seqs([s], max_len=len(s))
                pipe.add_sequence((target, fi), enc[0])


def _run(pipe, sizing, seq_files, k, w):
    try:
        _feed(pipe, seq_files)
        pipe.finish_counts()
        hashes_count = {t: c for t, c in pipe.hashes_count().items() if c}
        icfg = sizing.size_filter(hashes_count, kmer_size=k, window_size=w,
                                  max_fp=0.05)
        if isinstance(pipe, tdb.DeviceBuildPipeline):
            return hashes_count, icfg, pipe.scatter(
                icfg, sizing.split_target_bins(icfg, hashes_count))
        return hashes_count, icfg, pipe.scatter(icfg)
    finally:
        pipe.close()


def _jax_host(seq_files, k, w):
    """The JAX package's host-array path: per-file distinct minimizers
    (``sequence_hashes``), then ``build_ibf``."""
    from ganon_tpu.index.builder import sequence_hashes
    from ganon_tpu.index.ibf import build_ibf

    target_hashes = {}
    for target, files in seq_files.items():
        parts = []
        for seqs in files:
            hs = [h for h in (sequence_hashes(s, k, w) for s in seqs) if len(h)]
            if hs:
                parts.append(np.unique(np.concatenate(hs)))
        if parts:
            target_hashes[target] = np.concatenate(parts)
    ibf = build_ibf(target_hashes, kmer_size=k, window_size=w, max_fp=0.05)
    return ibf.hashes_count, ibf.ibf_config, ibf.bits


def _case(name, rng):
    """(seq_files, k, w) of each tests/test_device_build.py case, plus
    w == k and k = 32 (minimizer values at and above 2^63)."""
    if name == "multibin":
        # one target 10x the others: the sizing splits it over bins
        return {"T0": [[_random_seq(rng, 9000)] for _ in range(3)],
                **{f"T{t}": [[_random_seq(rng, 2500)]] for t in (1, 2, 3)}
                }, K, W
    if name == "duplicate_across_files":
        s = _random_seq(rng, 3000)
        return {"T0": [[s], [s]], "T1": [[_random_seq(rng, 2000)]]}, K, W
    if name == "long_sequence":
        return {"T0": [[_random_seq(rng, CHUNK + CHUNK // 2)]]}, K, W
    if name == "w_equals_k":
        return _mkinput(rng, n_targets=2, seq_len=2500), 19, 19
    if name == "k32":
        # w == k == 32: every canonical k-mer is a minimizer, about a
        # quarter of them >= 2^63
        return _mkinput(rng, n_targets=2, seq_len=3000), 32, 32
    if name == "short_and_empty":
        # sequences shorter than w, and a target with nothing to index
        return {"T0": [[_random_seq(rng, 20), _random_seq(rng, 3000)]],
                "T1": [[_random_seq(rng, 10)]],
                "T2": [[_random_seq(rng, 2000)], [_random_seq(rng, 5)]]}, K, W
    return _mkinput(rng), K, W


@pytest.mark.parametrize("case, cache, groups", [
    ("counts_bits", None, 0),
    ("multibin", None, 0),
    ("duplicate_across_files", None, 0),
    ("cache_trim", 0, 0),
    ("long_sequence", None, 0),
    ("w_equals_k", None, 0),
    ("k32", None, 0),
    ("short_and_empty", None, 0),
    ("groups_trimmed", 30000, 6000),
])
def test_pipeline_matches_jax(case, cache, groups, monkeypatch):
    """Counts, IBFConfig and bits equal the JAX pipeline's (and with a
    cache budget of 0 every group is re-extracted from the spill).

    With w == k every window position is a minimizer and the JAX pipeline
    takes its overflow fallback, which writes into the read-only array of
    its fetched matrix and raises on the CPU; those cases compare with the
    JAX host-array path, which the JAX pipeline's own tests hold equal.
    """
    seq_files, k, w = _case(case, np.random.default_rng(zlib.crc32(
        case.encode())))
    if groups:
        monkeypatch.setattr(tdb, "GROUP_BASES", groups)
    if w == k:
        want = _jax_host(seq_files, k, w)
    else:
        want = _run(JaxPipeline(k, w), jsizing, seq_files, k, w)
    pipe = tdb.DeviceBuildPipeline(k, w, device="cpu",
                                   device_cache_bytes=cache)
    got = _run(pipe, tsizing, seq_files, k, w)
    assert got[0] == want[0]
    assert got[1].to_dict() == want[1].to_dict()
    assert got[2].dtype == np.uint32 and np.array_equal(got[2], want[2])
    if groups:
        assert len(pipe.groups) > 2
    if case == "multibin":
        splits = tsizing.split_target_bins(got[1], got[0])
        assert len(splits) > len(got[0])  # some target spans bins
    if case == "duplicate_across_files":
        assert got[0]["T0"] % 2 == 0


def test_k32_values_reach_the_sign_bit():
    """The k = 32 case really holds values >= 2^63 (the unsigned order)."""
    from ganon_tpu_torch.index.builder import sequence_hashes

    seq_files, k, w = _case("k32", np.random.default_rng(zlib.crc32(b"k32")))
    h = np.concatenate([sequence_hashes(s, k, w, device="cpu")
                        for files in seq_files.values()
                        for seqs in files for s in seqs])
    assert (h >= np.uint64(1 << 63)).any() and (h < np.uint64(1 << 63)).any()


def test_pipeline_cache_budget(monkeypatch):
    """Every sort leaves the cached entries and its own working set (37
    bytes an entry: three entry buffers and the status words) within the
    budget, some groups stay cached and the rest are re-extracted, and the
    bits still equal the JAX pipeline's."""
    seq_files = _mkinput(np.random.default_rng(11))
    monkeypatch.setattr(tdb, "GROUP_BASES", 6000)
    limit = 60_000
    pipe = tdb.DeviceBuildPipeline(K, W, device="cpu",
                                   device_cache_bytes=limit)
    seen = []
    sort = tdb.sort_entries

    def watched_sort(key, val, **kw):
        seen.append((pipe._cache_bytes, key.numel()))
        return sort(key, val, **kw)

    monkeypatch.setattr(tdb, "sort_entries", watched_sort)
    try:
        _feed(pipe, seq_files)
        pipe.finish_counts()
        cached = [g for g in pipe.groups if g.sorted is not None]
        assert 0 < len(cached) < len(pipe.groups)
        assert pipe._cache_bytes == sum(12 * g.n for g in cached) <= limit
    finally:
        pipe.close()
    assert all(c == 0 or c + 37 * n <= limit for c, n in seen)
    got = _run(tdb.DeviceBuildPipeline(K, W, device="cpu",
                                       device_cache_bytes=limit),
               tsizing, seq_files, K, W)
    want = _run(JaxPipeline(K, W), jsizing, seq_files, K, W)
    assert got[0] == want[0] and np.array_equal(got[2], want[2])


@pytest.mark.parametrize("where", ["pipeline", "sort", "pack"])
def test_entry_count_guard(where, monkeypatch):
    """A group past the kernels' int32 limit raises a clear error before
    the launch that would overflow (the limit lowered to reach it)."""
    monkeypatch.setattr(build_ops, "MAX_ENTRIES", 100)
    with pytest.raises(ValueError, match="int32"):
        if where == "pipeline":
            _run(tdb.DeviceBuildPipeline(K, W, device="cpu"), tsizing,
                 _mkinput(np.random.default_rng(3), n_targets=1), K, W)
        elif where == "sort":
            build_ops.sort_entries(torch.zeros(101, dtype=torch.int32),
                                   torch.zeros(101, dtype=torch.int64),
                                   key_bits=1)
        else:
            build_ops.pack_entries(torch.zeros((2, 60), dtype=torch.int64),
                                   torch.full((2,), 60, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), 120)


def test_pipeline_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdb.DeviceBuildPipeline(K, W)


# --- plain kernels against their JAX device programs --------------------------


def _jax_kernels():
    from ganon_tpu.index.device_build import _kernels

    return _kernels()


def _sort_flat(keys, vals):
    """JAX's sort_flat of (key, u64 value) entries, as numpy (key, value)."""
    import jax.numpy as jnp

    from ganon_tpu.ops.bigsort import sort_flat

    k_s, hi_s, lo_s = sort_flat(
        (jnp.asarray(keys), jnp.asarray((vals >> np.uint64(32)).astype(
            np.uint32)), jnp.asarray(vals.astype(np.uint32))), 3,
        lo_pad=(-1, 0, 0),
        hi_pad=(np.iinfo(np.int32).max, 0xFFFFFFFF, 0xFFFFFFFF))
    return np.asarray(k_s), (np.asarray(hi_s).astype(np.uint64)
                             << np.uint64(32)) | np.asarray(lo_s).astype(
                                 np.uint64)


@pytest.mark.parametrize("n", [1, 5000, 300_000])
def test_sort_plain_matches_sort_flat(n):
    """K19: the plain sort orders (key, unsigned value) as sort_flat's
    lexicographic (key, hi, lo) with u32 halves, columnsort included."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 37, size=n).astype(np.int32)
    vals = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    vals[rng.integers(0, n, size=n // 5)] = vals[
        rng.integers(0, n, size=n // 5)]  # duplicates
    vals[: n // 3] |= np.uint64(1 << 63)
    want_k, want_v = _sort_flat(keys, vals)
    got_k, got_v = build_ops.sort_entries(
        torch.from_numpy(keys), u64_to_torch(vals), key_bits=6)
    assert np.array_equal(got_k.numpy(), want_k)
    assert np.array_equal(got_v.numpy().view(np.uint64), want_v)


# (files, key_bits, value bits, the digits the plan must keep)
_PLAN_CASES = {
    "equal-values": (5, 3, None, [8]),
    "one-file": (1, 0, 64, list(range(8))),
    "k19-38-bit": (37, 6, 38, [0, 1, 2, 3, 4, 8]),
    "k32-sign-bit": (9, 4, 64, list(range(9))),
    "key-bits-0": (1, 0, 38, [0, 1, 2, 3, 4]),
    "key-bits-16": (40_000, 16, 38, [0, 1, 2, 3, 4, 8, 9]),
    "constant-high-digits": (3, 2, 24, [0, 1, 2, 8]),
}


def _lsd(entries, digit_of, digits):
    """Stable torch.sort passes over the given digits, lowest first."""
    for d in digits:
        o = torch.sort(digit_of(*entries, d), stable=True).indices
        entries = [e[o] for e in entries]
    return entries


@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_sort_pass_plan_matches_sort_flat(case):
    """K19's pass plan: an LSD sort that runs a stable torch.sort over only
    the digits sort_pass_plan keeps (the card's passes) orders the entries
    as sort_flat does; constant digits (equal values, one file, values
    below 2^38, constant non-zero high bytes) are the ones skipped."""
    R, key_bits, vbits, want_digits = _PLAN_CASES[case]
    n = 6000
    rng = np.random.default_rng(len(case))
    keys = rng.integers(0, R, size=n).astype(np.int32)
    if vbits is None:
        vals = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    else:
        vals = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        if vbits < 64:
            vals &= np.uint64((1 << vbits) - 1)
        vals[rng.integers(0, n, size=n // 5)] = vals[: n // 5]  # duplicates
    if case == "k32-sign-bit":
        vals[: n // 2] |= np.uint64(1 << 63)
    if case == "constant-high-digits":
        vals |= np.uint64(0xAB00_5A00_0000_0000)
    key, val = torch.from_numpy(keys), u64_to_torch(vals)
    hist = build_ops.sort_digit_histograms(key, val, key_bits=key_bits)
    D = build_ops.sort_digits(key_bits)
    assert hist.shape == (2, D, 256)
    assert torch.equal(hist[0].sum(dim=1), torch.full((D,), n,
                                                      dtype=torch.int64))
    assert torch.equal(hist[1], torch.cumsum(hist[0], 1) - hist[0])
    digits = build_ops.sort_pass_plan(hist[0], key_bits=key_bits)
    assert digits == want_digits
    want_k, want_v = _sort_flat(keys, vals)
    got_k, got_v = _lsd([key, val], build_ops.sort_digit, digits)
    assert np.array_equal(got_k.numpy(), want_k)
    assert np.array_equal(got_v.numpy().view(np.uint64), want_v)


def test_sort_pass_plan_edges():
    """No entry or one: no pass; the histogram rows must match key_bits."""
    for n in (0, 1):
        key = torch.zeros(n, dtype=torch.int32)
        val = torch.full((n,), -5, dtype=torch.int64)
        hist = build_ops.sort_digit_histograms(key, val, key_bits=9)[0]
        assert build_ops.sort_pass_plan(hist, key_bits=9) == []
    with pytest.raises(ValueError, match="digit histograms"):
        build_ops.sort_pass_plan(hist, key_bits=17)


def _close_inputs(rng, R, cap):
    vals = rng.integers(0, 1 << 64, size=(R, cap), dtype=np.uint64)
    vals[:, 1::3] = vals[:, ::3][:, : vals[:, 1::3].shape[1]]  # duplicates
    vals[R // 2] = vals[0]  # a second file with the same values
    n = rng.integers(0, cap + 1, size=R).astype(np.int32)
    n[1] = 0  # a piece with nothing
    keys = np.sort(rng.integers(0, R // 2, size=R)).astype(np.int32)
    return vals, n, keys


def _port_close(vals, n, keys, R):
    """pack -> sort -> dedup (counts) through the plain versions."""
    key, val = build_ops.pack_entries(
        u64_to_torch(vals.reshape(-1)).reshape(vals.shape),
        torch.from_numpy(n), torch.from_numpy(keys), int(n.sum()))
    key, val = build_ops.sort_entries(key, val, key_bits=int(R).bit_length())
    counts = torch.zeros(R, dtype=torch.int32)
    uniq, rank = build_ops.dedup(key, val, num_files=R, counts=counts)
    return key, val, uniq, rank, counts


@pytest.mark.parametrize("R, cap", [(8, 64), (32, 1024)])
def test_close_sort_and_counts_match_jax(R, cap):
    """K10: pack + sort + dedup equal close_sort's sorted entries and
    first-occurrence mask and close_counts_sorted's per-file counts."""
    import jax.numpy as jnp

    _, close_sort, close_counts_sorted, _, _ = _jax_kernels()
    vals, n, keys = _close_inputs(np.random.default_rng(R), R, cap)
    ovf = jnp.zeros(R, dtype=bool)
    k_s, hi_s, lo_s, juniq = close_sort(jnp.asarray(vals), jnp.asarray(n),
                                        jnp.asarray(keys), ovf)
    jcounts, _ = close_counts_sorted(k_s, jnp.asarray(keys), ovf, juniq)
    key, val, uniq, rank, counts = _port_close(vals, n, keys, R)
    N = key.numel()
    assert N == int(n.sum())
    assert np.array_equal(key.numpy(), np.asarray(k_s)[:N])
    assert (np.asarray(k_s)[N:] == R).all()  # JAX's padding sorts last
    want_v = (np.asarray(hi_s).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo_s).astype(np.uint64)
    assert np.array_equal(val.numpy().view(np.uint64), want_v[:N])
    assert np.array_equal(uniq.numpy().astype(bool), np.asarray(juniq)[:N])
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert np.array_equal(rank.numpy(),
                          np.cumsum(uniq.numpy()) - uniq.numpy())


@pytest.mark.parametrize("h, mhb", [(1, 7), (3, 40), (5, 1000)])
def test_scatter_ranked_matches_scatter_sorted(h, mhb):
    """K10: the ranked scatter's bits equal scatter_sorted's for the same
    per-file split parameters (a file's target split over bins)."""
    import jax.numpy as jnp

    R, cap, bin_size = 16, 128, 1021
    _, close_sort, close_counts_sorted, scatter_sorted, _ = _jax_kernels()
    vals, n, keys = _close_inputs(np.random.default_rng(h), R, cap)
    ovf = jnp.zeros(R, dtype=bool)
    k_s, hi_s, lo_s, juniq = close_sort(jnp.asarray(vals), jnp.asarray(n),
                                        jnp.asarray(keys), ovf)
    counts = np.asarray(close_counts_sorted(k_s, jnp.asarray(keys), ovf,
                                            juniq)[0])
    # two files per target, files of one target adjacent
    params = np.zeros((4, R), dtype=np.int32)
    binno = 0
    for f in range(0, R, 2):
        c = int(counts[f] + counts[f + 1])
        nb = -(-c // mhb) if c else 0
        nhb = min(-(-c // nb), mhb) if nb else 1
        params[:3, f] = (binno, nhb, 0)
        params[:3, f + 1] = (binno, nhb, counts[f])
        binno += nb
    n_words = -(-binno // 32)
    params[3] = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = np.asarray(scatter_sorted(
        jnp.zeros(bin_size * n_words, jnp.uint32), k_s, hi_s, lo_s, juniq,
        jnp.zeros(R, dtype=bool), jnp.asarray(params[:3]),
        bin_size=bin_size, hash_functions=h, n_words=n_words,
    )).reshape(bin_size, n_words)
    key, val, uniq, rank, _ = _port_close(vals, n, keys, R)
    bits = torch.zeros((bin_size, n_words), dtype=torch.int32)
    build_ops.scatter_ranked(bits, key, val, uniq, rank,
                             torch.from_numpy(params), bin_size=bin_size,
                             hash_functions=h)
    assert want.any()
    assert np.array_equal(bits.numpy().view(np.uint32), want)


def _ranked_case(h, mhb, R=16, cap=128, bin_size=1021):
    """JAX close_sort's entries, close_counts_sorted's counts, the split
    params of two files a target, and scatter_sorted's matrix."""
    import jax.numpy as jnp

    _, close_sort, close_counts_sorted, scatter_sorted, _ = _jax_kernels()
    vals, n, keys = _close_inputs(np.random.default_rng(h), R, cap)
    ovf = jnp.zeros(R, dtype=bool)
    k_s, hi_s, lo_s, juniq = close_sort(jnp.asarray(vals), jnp.asarray(n),
                                        jnp.asarray(keys), ovf)
    counts = np.asarray(close_counts_sorted(k_s, jnp.asarray(keys), ovf,
                                            juniq)[0])
    params = np.zeros((4, R), dtype=np.int32)
    binno = 0
    for f in range(0, R, 2):
        c = int(counts[f] + counts[f + 1])
        nb = -(-c // mhb) if c else 0
        nhb = min(-(-c // nb), mhb) if nb else 1
        params[:3, f] = (binno, nhb, 0)
        params[:3, f + 1] = (binno, nhb, counts[f])
        binno += nb
    n_words = -(-binno // 32) + 2  # two word columns no bin reaches
    params[3] = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = np.asarray(scatter_sorted(
        jnp.zeros(bin_size * n_words, jnp.uint32), k_s, hi_s, lo_s, juniq,
        jnp.zeros(R, dtype=bool), jnp.asarray(params[:3]),
        bin_size=bin_size, hash_functions=h, n_words=n_words,
    )).reshape(bin_size, n_words)
    return (vals, n, keys), counts, params, want


@pytest.mark.parametrize("h, mhb", [(1, 7), (3, 40), (5, 1000)])
def test_fused_scatter_ranked_matches_scatter_sorted(h, mhb):
    """K10 as pass 2 runs it: scatter_ranked with uniq and rank None (the
    first occurrences and ranks made in the call; plain: dedup_plain, then
    scatter_ranked_plain) equals scatter_sorted, whole and in row spans,
    and ranked_word_cols holds every first occurrence's bin."""
    R, bin_size = 16, 1021
    inputs, counts, params, want = _ranked_case(h, mhb, R, 128, bin_size)
    key, val, uniq, rank, got_c = _port_close(*inputs, R)
    assert np.array_equal(got_c.numpy(), counts)
    pt = torch.from_numpy(params)
    cols = build_ops.ranked_word_cols(params, counts)
    _, bins = build_ops._ranked_bins(key, uniq, rank, pt)
    assert cols[0] <= int(bins.min()) >> 5
    assert int(bins.max()) >> 5 < cols[1] <= want.shape[1] - 2
    n_words = want.shape[1]
    bits = torch.zeros((bin_size, n_words), dtype=torch.int32)
    build_ops.scatter_ranked(bits, key, val, None, None, pt,
                             bin_size=bin_size, hash_functions=h,
                             word_cols=cols)
    assert want.any()
    assert np.array_equal(bits.numpy().view(np.uint32), want)
    for r0, r1 in ((0, 400), (400, 1021), (1021, 1100)):
        span = torch.zeros((r1 - r0, n_words), dtype=torch.int32)
        build_ops.scatter_ranked(span, key, val, None, None, pt,
                                 bin_size=bin_size, hash_functions=h,
                                 w0=r0 * n_words, word_cols=cols)
        assert np.array_equal(span.numpy().view(np.uint32)[:max(
            min(r1, bin_size) - r0, 0)], want[r0:r1])
    with pytest.raises(ValueError, match="uniq and rank"):
        build_ops.scatter_ranked(bits, key, val, uniq, None, pt,
                                 bin_size=bin_size, hash_functions=h)
    with pytest.raises(ValueError, match="first word of a row"):
        build_ops.scatter_ranked(bits[:10], key, val, None, None, pt,
                                 bin_size=bin_size, hash_functions=h, w0=1)


@pytest.mark.parametrize("mode", ["flat", "ranked", "span"])
def test_scatter_bits_do_not_depend_on_word_cols(mode):
    """word_cols, the band of the card's tiles, is a hint: the plain
    versions set scatter_sorted's bits whatever band they are given (the
    card sets a bit outside it with an atomicOr), one that holds every
    bin, one that leaves bins out on either side, and one that holds
    none."""
    from ganon_tpu_torch.index.ibf import scatter_hashes

    h, R, bin_size = 3, 16, 1021
    inputs, counts, params, want = _ranked_case(h, 7, R, 128, bin_size)
    key, val, uniq, rank, _ = _port_close(*inputs, R)
    pt = torch.from_numpy(params)
    c0, c1 = build_ops.ranked_word_cols(params, counts)
    assert c1 - c0 >= 2
    u, bins = build_ops._ranked_bins(key, uniq, rank, pt)
    r0 = 400 if mode == "span" else 0
    for cols in ((c0, c1), (c0 + 1, c1), (c0, c1 - 1), (c1, want.shape[1]),
                 None):
        bits = torch.zeros((bin_size - r0, want.shape[1]), dtype=torch.int32)
        if mode == "flat":
            scatter_hashes(bits, val[u], bins.to(torch.int32),
                           bin_size=bin_size, hash_functions=h,
                           word_cols=cols)
        else:
            build_ops.scatter_ranked(
                bits, key, val, None, None, pt, bin_size=bin_size,
                hash_functions=h, word_cols=cols,
                w0=r0 * want.shape[1] if mode == "span" else None)
        assert np.array_equal(bits.numpy().view(np.uint32), want[r0:]), cols


@pytest.mark.parametrize("R, cap", [(8, 64), (32, 1024)])
def test_dedup_counts_mode_matches_jax(R, cap):
    """Pass 1's dedup: counts only (added to the caller's), no [N] array
    back; close_counts_sorted's counts. Without counts there is nothing
    to compute."""
    import jax.numpy as jnp

    _, close_sort, close_counts_sorted, _, _ = _jax_kernels()
    vals, n, keys = _close_inputs(np.random.default_rng(R + 1), R, cap)
    ovf = jnp.zeros(R, dtype=bool)
    k_s, _, _, juniq = close_sort(jnp.asarray(vals), jnp.asarray(n),
                                  jnp.asarray(keys), ovf)
    want = np.asarray(close_counts_sorted(k_s, jnp.asarray(keys), ovf,
                                          juniq)[0])
    key, val, _, _, _ = _port_close(vals, n, keys, R)
    counts = torch.full((R,), 3, dtype=torch.int32)
    assert build_ops.dedup(key, val, num_files=R, counts=counts,
                           want_rank=False) == (None, None)
    assert np.array_equal(counts.numpy() - 3, want)
    with pytest.raises(ValueError, match="pass counts"):
        build_ops.dedup(key, val, num_files=R, want_rank=False)


@pytest.mark.parametrize("rows, n_words, cols, tile, max_tiles", [
    (2_709_945, 32, (0, 5), 24576, 4096),
    (2_709_945, 32, None, 24576, 4096),
    (9001, 72, (1, 70), 64, 16),
    (5003, 6, None, 24576, 4096),
    (100, 200_000, (7, 150_000), 24576, 16),
])
def test_scatter_windows_cover_the_rows(rows, n_words, cols, tile, max_tiles,
                                        monkeypatch):
    """The card scatter's plan: the band holds word_cols, the tiles fit
    TILE_WORDS, each window at most MAX_TILES tiles, the windows cut the
    rows in order; a call's entries are whole 4096-entry blocks whose run
    positions fit apply's shared memory beside a tile."""
    monkeypatch.setattr(build_ops, "TILE_WORDS", tile)
    monkeypatch.setattr(build_ops, "MAX_TILES", max_tiles)
    c0, band, cw, rpt, windows = build_ops.scatter_windows(rows, n_words,
                                                           cols)
    lo, hi = cols or (0, n_words)
    assert (c0, c0 + band) == (lo, hi)
    assert 1 <= cw <= band and cw * rpt <= tile
    ncb = -(-band // cw)
    assert [w[0] for w in windows] == [0] + [w[1] for w in windows[:-1]]
    assert windows[-1][1] == rows
    assert all(ncb * -(-(b - a) // rpt) <= max_tiles for a, b in windows)
    for h in range(1, 6):
        chunk = build_ops.scatter_chunk(h)
        assert chunk % 4096 == 0 and chunk * h <= build_ops.ITEM_BUDGET
        assert tile + 2 * (chunk // 4096) + 1 <= (232448 - 512) // 4
    with pytest.raises(ValueError, match="outside"):
        build_ops.scatter_windows(rows, n_words, (0, n_words + 1))


# --- run_build and run_build_hibf against the JAX package ---------------------


def _write_fasta(path, seqs, rng):
    text = "".join(
        f">s{i} desc\n" + "\n".join(s[j:j + 70] for j in range(0, len(s), 70))
        + "\n" for i, s in enumerate(seqs))
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


@pytest.fixture(scope="module")
def build_inputs(tmp_path_factory):
    """A target_info over 6 targets: two files for some (one gzipped), a
    sequence shorter than w, a file that is empty and one that is missing;
    one large target that spans several technical bins."""
    d = tmp_path_factory.mktemp("build_inputs")
    rng = np.random.default_rng(31)
    rows = []
    for t in range(6):
        nfiles = 2 if t % 2 == 0 else 1
        for fi in range(nfiles):
            ext = ".fna.gz" if fi == 1 else ".fna"
            path = str(d / f"t{t}_{fi}{ext}")
            lens = [20, 3000 + 700 * t] + ([40_000] if t == 5 else [])
            _write_fasta(path, [_random_seq(rng, n) for n in lens], rng)
            rows.append((path, f"T{t}"))
    empty = d / "empty.fna"
    empty.write_text("")
    rows.insert(3, (str(empty), "T1"))
    rows.append((str(d / "missing.fna"), "T9"))
    ti = d / "target_info.tsv"
    ti.write_text("".join(f"{p}\t{t}\n" for p, t in rows))
    return str(ti)


def _ibf_state(ibf):
    return (np.asarray(ibf.bits), ibf.ibf_config.to_dict(), ibf.hashes_count,
            [tuple(x) for x in ibf.bin_map])


@pytest.mark.parametrize("pipeline, fmt, opts", [
    ("host", "tpu", {}),
    ("device", "tpu", {"hash_functions": 3}),
    ("host", "tpu-raw", {"min_length": 3500}),
    ("device", "tpu-raw", {"threads": 2}),
    ("host", "reference", {"hash_functions": 4,
                           "hash_functions_defaulted": True}),
    ("device", "reference", {"threads": 2, "min_length": 100}),
])
def test_run_build_matches_jax(build_inputs, tmp_path, monkeypatch, pipeline,
                               fmt, opts):
    """run_build writes the JAX package's filter: npz by arrays and
    header, tpu-raw and reference byte-equal; either JAX pipeline."""
    from ganon_tpu.index.builder import BuildConfig as JaxConfig
    from ganon_tpu.index.builder import run_build as jax_run_build
    from ganon_tpu.index.ibf import IBF as JaxIBF
    from ganon_tpu_torch.index.builder import BuildConfig, run_build
    from ganon_tpu_torch.index.ibf import IBF

    monkeypatch.setenv("GANON_TPU_BUILD_PIPELINE", pipeline)
    kw = dict(input_file=build_inputs, max_fp=0.05, filter_format=fmt, **opts)
    jax_out, port_out = str(tmp_path / "jax.ibf"), str(tmp_path / "port.ibf")
    jax_run_build(JaxConfig(output_file=jax_out, **kw))
    ibf = run_build(BuildConfig(output_file=port_out, device="cpu", **kw))
    assert len(ibf.hashes_count) >= 5
    if fmt == "tpu":
        a, b = _ibf_state(JaxIBF.load(jax_out)), _ibf_state(IBF.load(port_out))
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    else:
        with open(jax_out, "rb") as fa, open(port_out, "rb") as fb:
            assert fa.read() == fb.read()
    if pipeline == "host" and fmt == "tpu":
        splits = tsizing.split_target_bins(ibf.ibf_config, ibf.hashes_count)
        assert len(splits) > len(ibf.hashes_count)


@pytest.mark.parametrize("layout, fmt, min_targets", [
    ("auto", "tpu-raw", None),   # below the threshold: the forest
    ("auto", "tpu-raw", 4),      # at it: the pruned forest
    ("forest", "tpu-raw", None),
    ("pruned", "tpu-raw", None),
    ("pruned", "tpu", None),
    ("auto", "reference", 4),    # reference export keeps the forest
])
def test_run_build_hibf_matches_jax(build_inputs, tmp_path, monkeypatch,
                                    layout, fmt, min_targets):
    from ganon_tpu.index import hibf as jhibf
    from ganon_tpu_torch.index import hibf as thibf

    if min_targets is not None:
        monkeypatch.setattr(jhibf, "PRUNED_AUTO_MIN_TARGETS", min_targets)
        monkeypatch.setattr(thibf, "PRUNED_AUTO_MIN_TARGETS", min_targets)
    kw = dict(target_info_file=build_inputs, kmer_size=K, window_size=W,
              max_fp=0.05, filter_format=fmt, layout=layout)
    jax_out, port_out = str(tmp_path / "jax.hibf"), str(tmp_path / "port.hibf")
    jres = jhibf.run_build_hibf(output_file=jax_out, **kw)
    tres = thibf.run_build_hibf(output_file=port_out, device="cpu", **kw)
    assert type(jres).__name__ == type(tres).__name__
    if layout == "auto" and fmt != "reference":
        assert type(tres).__name__ == (
            "PrunedForest" if min_targets else "HIBF")
    if fmt == "tpu":
        from ganon_tpu.index.pruned import PrunedForest as JPF
        from ganon_tpu_torch.index.pruned import PrunedForest as TPF

        a, b = JPF.load(jax_out), TPF.load(port_out)
        for name in ("fine", "coarse", "grp_bin_size", "grp_row_off"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        assert a.targets() == b.targets()
    else:
        with open(jax_out, "rb") as fa, open(port_out, "rb") as fb:
            assert fa.read() == fb.read()
