"""Bloom-filter sizing math: bin size, hash functions, optimal split search.

Formula-level parity with the reference engine (the formulas are facts of
the IBF data structure; the search is re-implemented over deterministic
dict ordering):

* ``bin_size_fp``            <- GanonBuild.cpp:290-296
* ``bin_size_fp_hf``         <- GanonBuild.cpp:298-306
* ``hash_functions_from_ratio`` / ``get_optimal_hash_functions``
                             <- GanonBuild.cpp:308-333
* ``number_of_bins``         <- GanonBuild.cpp:336-347
* ``correction_rate``        <- GanonBuild.cpp:350-362
* ``optimal_bins`` (64-pad)  <- GanonBuild.cpp:365-371
* ``false_positive``         <- GanonBuild.cpp:373-380
* ``true_false_positive``    <- GanonBuild.cpp:382-412
* ``optimal_hashes`` search with modes avg/smaller/smallest/faster/fastest
                             <- GanonBuild.cpp:428-616
* ``split_target_bins``      <- create_bin_map_hash, GanonBuild.cpp:619-653
* ``target_fpr``             <- GanonClassify.cpp:968-982
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ganon_tpu_torch.index.config import IBFConfig

MAX_HASH_FUNCTIONS = 5


def bin_size_fp(max_fp: float, n_hashes: int) -> int:
    """Optimal Bloom bin size in bits for a target fp (optimal #hashes)."""
    return math.ceil((n_hashes * math.log(max_fp)) / math.log(1.0 / 2 ** math.log(2)))


def bin_size_fp_hf(max_fp: float, n_hashes: int, hash_functions: int) -> int:
    """Bloom bin size in bits for a target fp with a fixed #hash functions."""
    return math.ceil(
        n_hashes
        * (-hash_functions / math.log(1 - math.exp(math.log(max_fp) / hash_functions)))
    )


def hash_functions_from_ratio(bin_size_bits: int, n_hashes: int) -> int:
    return int(math.log(2) * (bin_size_bits / n_hashes))


def get_optimal_hash_functions(
    bin_size_bits: int,
    n_hashes: int,
    hash_functions: int = 0,
    max_hash_functions: int = MAX_HASH_FUNCTIONS,
) -> int:
    hf = hash_functions
    if hf == 0:
        hf = hash_functions_from_ratio(bin_size_bits, n_hashes)
    if hf > max_hash_functions or hf == 0:
        hf = max_hash_functions
    return hf


def number_of_bins(hashes_count: dict[str, int], n_hashes: int) -> int:
    """Total technical bins if every target is split every ``n_hashes``."""
    return sum(math.ceil(c / n_hashes) for c in hashes_count.values())


def optimal_bins(n_bins: int) -> int:
    """64-pad the bin count (the IBF stores bins in 64-bit words)."""
    return math.ceil(n_bins / 64.0) * 64


def false_positive(bin_size_bits: int, hash_functions: int, n_hashes: int) -> float:
    """Theoretical fp of one Bloom bin."""
    return (1 - math.exp(-hash_functions / (bin_size_bits / n_hashes))) ** hash_functions


def correction_rate(
    max_split_bins: int, max_fp: float, hash_functions: int, n_hashes: int
) -> float:
    """Bin-size growth factor to compensate multiple testing on split bins."""
    target_fpr = 1.0 - math.exp(math.log(1.0 - max_fp) / max_split_bins)
    new_size = bin_size_fp_hf(target_fpr, n_hashes, hash_functions)
    original = bin_size_fp_hf(max_fp, n_hashes, hash_functions)
    return new_size / original


def true_false_positive(
    hashes_count: dict[str, int], max_hashes_bin: int, bin_size_bits: int,
    hash_functions: int,
) -> tuple[float, float]:
    """Achieved (max, avg) per-target fp accounting for split bins."""
    highest = 0.0
    total = 0.0
    for count in hashes_count.values():
        n_bins_target = math.ceil(count / max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        real_fp = 1.0 - (
            1.0 - false_positive(bin_size_bits, hash_functions, n_hashes_bin)
        ) ** n_bins_target
        highest = max(highest, real_fp)
        total += real_fp
    return highest, total / max(len(hashes_count), 1)


def target_fpr(
    hashes_count: dict[str, int], ibf_config: IBFConfig
) -> dict[str, float]:
    """Per-target achieved fp used by the --fpr-query filter."""
    out = {}
    for target, count in hashes_count.items():
        n_bins_target = math.ceil(count / ibf_config.max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        out[target] = 1.0 - (
            1.0
            - false_positive(
                ibf_config.bin_size_bits, ibf_config.hash_functions, n_hashes_bin
            )
        ) ** n_bins_target
    return out


@dataclass
class _Sim:
    n_hashes: int
    n_bins: int
    filter_size_bits: int
    fp: float


def optimal_hashes(
    max_fp: float,
    filter_size: float,
    ibf_config: IBFConfig,
    hashes_count: dict[str, int],
    hash_functions: int = 0,
    max_hash_functions: int = MAX_HASH_FUNCTIONS,
    mode: str = "avg",
) -> None:
    """Search the best max-hashes-per-bin; fills ``ibf_config`` in place.

    Scans candidate bin capacities every 100 elements from the largest
    target down, computes the resulting filter size (or fp when
    ``filter_size`` is fixed), and picks the capacity minimizing a
    mode-weighted harmonic mean of the size/fp ratio and the bin-count
    ratio against their minima.
    """
    max_hashes = max(hashes_count.values(), default=0)

    min_filter_size = 0
    min_bins = 0
    min_fp = 1.0
    simulations: list[_Sim] = []

    iter_step = 100
    if max_hashes < iter_step:
        iter_step = max_hashes

    n = max_hashes + 1
    while n > iter_step:
        n_hashes = n - 1
        n_bins = number_of_bins(hashes_count, n_hashes)

        bin_size_bits = 0
        if filter_size:
            bin_size_bits = int(
                (filter_size / optimal_bins(n_bins)) * 8388608
            )
            hf = get_optimal_hash_functions(
                bin_size_bits, n_hashes, hash_functions, max_hash_functions
            )
        else:
            if hash_functions == 0:
                bin_size_bits = bin_size_fp(max_fp, n_hashes)
                hf = get_optimal_hash_functions(
                    bin_size_bits, n_hashes, hash_functions, max_hash_functions
                )
            else:
                hf = get_optimal_hash_functions(
                    bin_size_bits, n_hashes, hash_functions, max_hash_functions
                )
                bin_size_bits = bin_size_fp_hf(max_fp, n_hashes, hf)

        max_split_bins = math.ceil(max_hashes / n_hashes)

        fp = 0.0
        filter_size_bits = 0
        if filter_size:
            fp = 1 - (1.0 - false_positive(bin_size_bits, hf, n_hashes)) ** max_split_bins
            if fp < min_fp:
                min_fp = fp
        else:
            avg_n_hashes = math.ceil(max_hashes / max_split_bins)
            approx_fp = false_positive(bin_size_bits, hf, avg_n_hashes)
            if approx_fp > max_fp:
                approx_fp = max_fp
            crate = correction_rate(max_split_bins, approx_fp, hf, n_hashes)
            bin_size_bits = int(bin_size_bits * crate)
            filter_size_bits = bin_size_bits * optimal_bins(n_bins)
            if filter_size_bits == 0 or math.isinf(crate):
                break
            if filter_size_bits < min_filter_size or min_filter_size == 0:
                min_filter_size = filter_size_bits

        simulations.append(_Sim(n_hashes, n_bins, filter_size_bits, fp))

        if n_bins < min_bins or min_bins == 0:
            min_bins = n_bins
        n -= iter_step

    # mode weighting: avg=1 (plain harmonic mean), smaller/faster=0.5,
    # smallest/fastest=0 (ignore the other metric entirely)
    mode_val = 1.0
    if mode in ("smaller", "faster"):
        mode_val = 0.5
    elif mode in ("smallest", "fastest"):
        mode_val = 0.0
    var_val = 1.0
    bins_val = 1.0
    if mode in ("smaller", "smallest"):
        var_val = mode_val
    elif mode in ("faster", "fastest"):
        bins_val = mode_val

    min_avg = 0.0
    for params in simulations:
        if filter_size:
            var_ratio = params.fp / min_fp
        else:
            var_ratio = params.filter_size_bits / min_filter_size
        bins_ratio = params.n_bins / min_bins
        avg = (1 + mode_val**2) * (
            (var_ratio * bins_ratio) / ((var_val * var_ratio) + (bins_val * bins_ratio))
        )
        if avg < min_avg or min_avg == 0:
            min_avg = avg
            if filter_size:
                ibf_config.bin_size_bits = int(
                    (filter_size / optimal_bins(params.n_bins)) * 8388608
                )
                ibf_config.max_fp = params.fp
            else:
                ibf_config.bin_size_bits = params.filter_size_bits // optimal_bins(
                    params.n_bins
                )
                ibf_config.max_fp = max_fp
            ibf_config.max_hashes_bin = params.n_hashes
            ibf_config.n_bins = params.n_bins
            ibf_config.hash_functions = get_optimal_hash_functions(
                ibf_config.bin_size_bits, params.n_hashes, hash_functions,
                max_hash_functions,
            )


# --------------------------------------------------------------------------
# TPU throughput-aware hash-function tuning
#
# Measured on TPU v5e (scripts/wide_table_bench.py + scripts/vmem_h_probe.py,
# production kernels): the bulk-count gather costs a fixed per-PROBE price,
# not per-byte, in three regimes:
#   1. u8 table <= ~32 MB: VMEM-staged, ~2 ns/probe flat for rows <= 128 B
#      (26.6 MB measured 2 ns; 33.7 MB u8 fell off the cliff to ~9 ns).
#   2. u32 word-view table <= ~96 MB (the layout DeviceFilter switches to
#      past the u8 budget): still effectively staged — an 83 MB u32 table
#      measured ~2 ns/probe at 32 B rows (vmem_h_probe, fused counts
#      program), NOT the 11 ns the old model assumed. Modeled as
#      3 + 0.011*row_bytes to interpolate toward the unstaged price for
#      wide rows we have not measured in this band.
#   3. beyond: HBM-transaction-bound ~(11 + 0.011 * row_bytes) ns/probe:
#      row_bytes 256: 13.8 ns   1024: 22 ns   4096: 56 ns
# A read costs (n_hashes x hash_functions) probes, so fewer hash
# functions win nearly linearly whenever the fp-equivalent re-size stays
# within the same (or a cheap) regime: measured h=4 -> h=1 gains of
# 1.43x on a 27 MB db (u8 VMEM -> 83 MB u32) and 3.2x at T=1024
# (891 MB -> 2.8 GB, both unstaged). The fp-equivalent table only grows
# (m/n for fp=0.05: h=4 -> 6.2 bits, h=2 -> 7.9, h=1 -> 19.5). The
# reference's auto sizing picks h for minimum MEMORY (ln2*m/n ratio,
# GanonBuild.cpp:308-333) — correct on CPU where bulk_count streams bins
# linearly, wrong for a TPU gather.

# conservative u8 VMEM staging budget (v5e VMEM is 128 MB; 26.6 MB u8
# measured staged, 33.7 MB measured unstaged in the fused counts
# program). The cliff sits somewhere in between; classify switches to
# the u32 word view past this, and the penalty for switching too early
# (~1.65x, u32 band vs staged u8) is far smaller than for staying u8
# past the cliff (~4.5x), so err low.
VMEM_STAGED_TABLE_BYTES = 28 << 20
# u32 word-view tables stay probe-cheap well past the u8 cliff (83 MB
# measured ~2 ns/probe; 223 MB measured fully HBM-bound)
U32_STAGED_TABLE_BYTES = 96 << 20
# do not let the tuner grow the filter beyond this (HBM working budget)
MAX_TUNED_TABLE_BYTES = 6 << 30
# ... nor beyond this factor of the memory-optimal size. The re-size cost
# explodes as h drops at strict fp (m/n for h=1: fp=0.05 -> 19.5 bits,
# fp=0.001 -> ~997 bits — 58x the h=5 optimum); the measured throughput
# wins (1.4-3.2x) all came from <=3.2x growth, and HBM is the scarce
# resource for RefSeq-scale databases.
MAX_TUNED_GROWTH = 4.0


def packed_row_bytes(max_hashes_bin: int, hashes_count: dict[str, int]) -> int:
    """Query-table row width in bytes under the byte-aligned packed layout.

    ``pack_table_u8`` pads every target's technical-bin range to whole
    bytes, so the row is ``sum_t ceil(bins_t / 8)`` bytes — up to 8x the
    interleaved ``optimal_bins // 8`` width when targets own few bins
    (e.g. 1024 single-bin targets pack to 1024 B rows, not 128 B). The
    measured cost model below is fit against this packed width.
    """
    mhb = max(max_hashes_bin, 1)
    total = 0
    for c in hashes_count.values():
        if c:
            bins_t = -(-c // mhb)
            total += -(-bins_t // 8)
    return total


def probe_cost_ns(table_bytes: int, row_bytes: int) -> float:
    """Measured per-probe gather cost model (v5e, see module comment)."""
    if table_bytes <= VMEM_STAGED_TABLE_BYTES:
        if row_bytes <= 128:
            return 2.0
        if row_bytes <= 256:
            return 2.3
        if row_bytes <= 512:
            return 2.8
        return 2.8 * row_bytes / 512
    if table_bytes <= U32_STAGED_TABLE_BYTES:
        # u32 word-view band: measured ~2 ns at 32 B rows; interpolate
        # toward the unstaged price for wide rows (unmeasured here)
        return 3.0 + 0.011 * row_bytes
    # HBM regime. Round-3 production trace (scripts/trace_batch.py,
    # T=1024 / 281 MB / 1 KB rows) measured 12.8 ns/probe vs this
    # model's 22 — the model overestimates wide rows, which is SAFE for
    # the h-tune (it only makes the tuner more conservative about
    # moving to fewer/wider probes); keep until a second point pins the
    # slope.
    return 11.0 + 0.011 * row_bytes


def auto_tune_hash_functions(
    max_fp: float,
    filter_size: float,
    ibf_config: IBFConfig,
    hashes_count: dict[str, int],
    hash_functions: int = 0,
    mode: str = "avg",
    bins_shards: int = 1,
) -> bool:
    """Re-size with fewer hash functions when that is measurably faster.

    Applies only when the user left ``--hash-functions`` on auto and
    sizes by ``--max-fp`` (with a fixed ``--filter-size``, fewer hashes
    would raise the fp instead). The probe-cost model decides across all
    gather regimes — per-probe cost is roughly flat within a regime, so
    fewer hash functions win whenever the fp-equivalent re-size (a
    larger but sparser table) lands in the same or a cheap regime;
    measured 1.43x end-to-end even for a VMEM-resident db (h=4, 27 MB ->
    h=1, 83 MB u32; scripts/vmem_h_probe.py). Returns True when it
    re-sized ``ibf_config`` (classify needs no change:
    ``hash_functions`` is part of the serialized IBFConfig).

    ``bins_shards``: number of chips the query table's bin axis will be
    column-sharded over at classify time (parallel/mesh.py); the cost
    model prices the PER-CHIP shard. Default 1 (conservative).
    """
    if hash_functions != 0 or filter_size or not max_fp:
        return False

    def cost(cfg: IBFConfig) -> float:
        rows = max(
            packed_row_bytes(cfg.max_hashes_bin, hashes_count)
            // max(bins_shards, 1),
            1,
        )
        table = cfg.bin_size_bits * rows
        return cfg.hash_functions * probe_cost_ns(table, rows)

    base_table = (
        ibf_config.bin_size_bits
        * packed_row_bytes(ibf_config.max_hashes_bin, hashes_count)
        // max(bins_shards, 1)
    )
    best_cfg, best_cost = None, cost(ibf_config)
    for h in range(1, ibf_config.hash_functions):
        cand = IBFConfig(
            kmer_size=ibf_config.kmer_size, window_size=ibf_config.window_size
        )
        optimal_hashes(
            max_fp, 0.0, cand, hashes_count, hash_functions=h, mode=mode
        )
        if cand.n_bins == 0:
            continue
        table = (
            cand.bin_size_bits
            * packed_row_bytes(cand.max_hashes_bin, hashes_count)
            // max(bins_shards, 1)
        )
        if table > MAX_TUNED_TABLE_BYTES:  # per-chip HBM budget
            continue
        if table > MAX_TUNED_GROWTH * max(base_table, 1):
            continue  # probe savings never justify unbounded memory
        c = cost(cand)
        if c < best_cost:
            best_cfg, best_cost = cand, c
    if best_cfg is None:
        return False
    ibf_config.bin_size_bits = best_cfg.bin_size_bits
    ibf_config.max_hashes_bin = best_cfg.max_hashes_bin
    ibf_config.n_bins = best_cfg.n_bins
    ibf_config.hash_functions = best_cfg.hash_functions
    ibf_config.max_fp = best_cfg.max_fp
    return True


def size_filter(
    hashes_count: dict[str, int],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.05,
    filter_size: float = 0.0,
    hash_functions: int = 0,
    mode: str = "avg",
    tpu_sizing: bool | None = None,
    bins_shards: int = 1,
) -> IBFConfig:
    """THE sizing entry point shared by every build path.

    Runs the reference-parity ``optimal_hashes`` search, optionally the
    TPU throughput re-size (``auto_tune_hash_functions``), and computes
    the achieved ``true_max_fp``/``true_avg_fp`` — so the host-array
    build (`ibf.build_ibf`), the device pipeline (`builder.run_build`),
    benches and tests all agree on one ``IBFConfig`` for the same
    inputs. Reference invariants: GanonBuild.cpp:428-616 (search),
    :382-412 (true fp).

    ``tpu_sizing=None`` derives the tune decision: only when the user
    left ``--hash-functions`` on auto and sizes by ``--max-fp``.
    """
    cfg = IBFConfig(kmer_size=kmer_size, window_size=window_size)
    eff_max_fp = max_fp if not filter_size else 0.0
    optimal_hashes(
        eff_max_fp, filter_size, cfg, hashes_count,
        hash_functions=hash_functions, mode=mode,
    )
    tune = hash_functions == 0 if tpu_sizing is None else tpu_sizing
    if tune:
        auto_tune_hash_functions(
            eff_max_fp, filter_size, cfg, hashes_count,
            hash_functions=0, mode=mode, bins_shards=bins_shards,
        )
    if cfg.n_bins == 0:
        raise ValueError("no valid sequences to build")
    cfg.true_max_fp, cfg.true_avg_fp = true_false_positive(
        hashes_count, cfg.max_hashes_bin, cfg.bin_size_bits,
        cfg.hash_functions,
    )
    return cfg


def split_target_bins(
    ibf_config: IBFConfig, hashes_count: dict[str, int]
) -> list[tuple[int, str, int, int]]:
    """Assign consecutive technical bins per target with hash index ranges.

    Returns ``[(binno, target, idx_start, idx_end_inclusive), ...]`` in
    deterministic target order (dict insertion order).
    """
    binno = 0
    out = []
    for target, count in hashes_count.items():
        n_bins_target = math.ceil(count / ibf_config.max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        if n_hashes_bin > ibf_config.max_hashes_bin:
            n_hashes_bin = ibf_config.max_hashes_bin
        for i in range(n_bins_target):
            st = i * n_hashes_bin
            en = st + n_hashes_bin - 1
            if st >= count:
                break
            if en >= count:
                en = count - 1
            out.append((binno, target, st, en))
            binno += 1
    return out
