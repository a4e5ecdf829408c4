"""Classification pipeline: hierarchy levels, thresholds, outputs.

Port of ``ganon_tpu.classify.engine``: the same ClassifyConfig,
multi-level hierarchies with leftover requeue (the cross-level
scheduler), levels of several databases (union targets, per-filter
rel-cutoff, winner-aware fpr-query), flat ``.ibf`` (the reference's
cereal archive too), native forest, raptor and merged-bin pruned forest
``.hibf`` filters, tallies, LCA and the
``.rep``/``.one``/``.all``/
``.unc``/``.sta`` writers, with the device work running as the kernels
of :mod:`ganon_tpu_torch.classify.device` on ``cfg.device``. Batches are
pipelined ``pipeline_depth`` deep: each dispatch enqueues its kernels and
a non-blocking copy of the packed result into pinned host memory, and
the host finishes the oldest batch after waiting on its copy's event.

A flat filter, forest or raptor archive of more than 65,535 targets, or
a ``hashes_limit`` above 65,535 (``--longreads``), runs the 32-bit
counter layout (``select``'s 32-bit mode), as the JAX engine's
``pack16 = False``. A pruned forest has no bound on its targets (its
matches travel as lane ids plus per-read group words); its fast path
needs at most 65,535 groups and a ``hashes_limit`` of at most 65,535,
and a level of several filters needs a union of at most 65,535 targets
and the same limit: otherwise their batches take the exact path.

With ``use_mesh`` and more than one local device of ``cfg.device``'s
type (:func:`ganon_tpu_torch.parallel.mesh.local_devices`), every filter
is sharded over a ``(batch, bins)`` mesh of them
(:mod:`ganon_tpu_torch.parallel.mesh`), as the JAX engine does; the
results are gathered on ``cfg.device``. One device keeps the plain path.

Every stage records a span of :mod:`ganon_tpu_torch.trace` (``engine.*``,
``dispatch.*``, ``finish.*``, ``writer.*`` on the writer thread,
``parse.batch`` on the parser's) and its counters; the returned
``timing`` and each level's ``transfer`` are read from them.
"""

from __future__ import annotations

import sys
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ganon_tpu_torch import trace
from ganon_tpu_torch.classify import device as dev
from ganon_tpu_torch.classify.lca import LCA, build_lca
from ganon_tpu_torch.classify.thresholds import FprQueryMinCount
from ganon_tpu_torch.io.pipeline import (
    BatchCoalescer,
    EncodedBatch,
    ThreadedBatchSource,
    bucketed_batches,
    encoded_batches,
    strided_batches,
)
from ganon_tpu_torch.parallel import mesh as pmesh


# --------------------------------------------------------------------------
# configuration


@dataclass
class FilterSpec:
    ibf_file: str
    tax_file: str = ""
    rel_cutoff: float = 0.2


@dataclass
class ClassifyConfig:
    """Mirrors the reference ganon-classify Config (Config.hpp:18-290).

    Every field of ``ganon_tpu.classify.engine.ClassifyConfig`` is kept
    (one config drives both engines), plus ``device``.
    """

    ibf: list = field(default_factory=list)
    tax: list = field(default_factory=list)
    single_reads: list = field(default_factory=list)
    paired_reads: list = field(default_factory=list)  # flat [r1, r2, r1, r2...]
    batch_reads: list = field(default_factory=list)
    output_prefix: str = ""
    hierarchy_labels: list = field(default_factory=lambda: ["H1"])
    rel_cutoff: list = field(default_factory=lambda: [0.2])
    rel_filter: list = field(default_factory=lambda: [0.0])
    fpr_query: list = field(default_factory=lambda: [1.0])
    output_lca: bool = False
    output_all: bool = False
    output_unclassified: bool = False
    output_stats: bool = False
    output_single: bool = False
    skip_lca: bool = False
    tax_root_node: str = "1"
    # device batch size; 0 = auto (8192)
    n_reads: int = 0
    # in-flight batches before finishing the oldest result
    pipeline_depth: int = 4
    # regroup read batches by length bucket before padding
    length_bucketing: bool = True
    hashes_limit: int = 65535  # uint16 counter limit; raise for long reads
    # pruned-forest fast path: surviving-group slots per read (a read
    # with more surviving groups takes the exact probe-all path)
    pruned_max_groups: int = 2
    # the pruned fast path's pair cap, as a fraction of the batch: the
    # (read, slot) pairs are compacted to it on the card (the "pairs"
    # kernel); a batch that overflows under the cap is retried once with
    # dense slots and the level's fraction raised by 0.5 (sticky), as the
    # JAX engine does; 0 turns the cap off
    pruned_pair_frac: float = 1.0
    device_thresholding: bool = True  # on-device cutoff/filter + top-K
    top_k_matches: int = 128  # compact output width (falls back if exceeded)
    use_mesh: bool = True  # shard over all devices when more than one
    # record-range sharding: keep records with index % stride == offset
    read_stride: int = 1
    read_offset: int = 0
    quiet: bool = True
    verbose: bool = False
    # torch device of the filter and the kernels ("cuda" or "cpu")
    device: str = "cuda"

    def validate(self) -> None:
        """Broadcast vector params (reference validate_hierarchy)."""
        if not self.output_prefix:
            raise ValueError("--output-prefix is mandatory")
        if not (self.single_reads or self.paired_reads or self.batch_reads):
            raise ValueError("at least one of --single|paired|batch-reads needed")
        if not self.ibf:
            raise ValueError("--ibf is mandatory")
        if len(self.paired_reads) % 2 != 0:
            raise ValueError("--paired-reads should be an even number of files")
        n_filters = len(self.ibf)
        if len(self.hierarchy_labels) == 1 and n_filters > 1:
            self.hierarchy_labels = self.hierarchy_labels * n_filters
        if len(self.hierarchy_labels) != n_filters:
            raise ValueError("--hierarchy-labels must match --ibf")
        uniq = len(set(self.hierarchy_labels))
        if len(self.rel_cutoff) == 1 and n_filters > 1:
            self.rel_cutoff = self.rel_cutoff * n_filters
        if len(self.rel_cutoff) != n_filters:
            raise ValueError("one --rel-cutoff per filter")
        if len(self.rel_filter) == 1 and uniq > 1:
            self.rel_filter = self.rel_filter * uniq
        if len(self.rel_filter) != uniq:
            raise ValueError("one --rel-filter per hierarchy")
        if len(self.fpr_query) == 1 and uniq > 1:
            self.fpr_query = self.fpr_query * uniq
        if len(self.fpr_query) != uniq:
            raise ValueError("one --fpr-query per hierarchy")
        if self.tax and len(self.tax) != len(self.ibf):
            raise ValueError("--ibf and --tax must match")
        if not self.tax:
            self.skip_lca = True
        for v in self.rel_cutoff + self.rel_filter + self.fpr_query:
            if v < 0 or v > 1:
                raise ValueError("threshold values must be within [0, 1]")


@dataclass
class HierarchyLevel:
    label: str
    filters: list  # list[FilterSpec]
    rel_filter: float
    fpr_query: float
    output_file_one: str
    output_file_all: str


def parse_hierarchy(cfg: ClassifyConfig) -> dict[str, HierarchyLevel]:
    """Group filters by sorted hierarchy label (GanonClassify.cpp:353-401)."""
    uniq = sorted(set(cfg.hierarchy_labels))
    levels: dict[str, HierarchyLevel] = {}
    hierarchy_count = 0
    for h, label in enumerate(cfg.hierarchy_labels):
        spec = FilterSpec(
            ibf_file=cfg.ibf[h],
            tax_file=cfg.tax[h] if cfg.tax else "",
            rel_cutoff=cfg.rel_cutoff[h],
        )
        if label not in levels:
            one, all_ = "one", "all"
            if len(uniq) > 1 and not cfg.output_single:
                one = f"{label}.one"
                all_ = f"{label}.all"
            levels[label] = HierarchyLevel(
                label=label,
                filters=[spec],
                rel_filter=cfg.rel_filter[hierarchy_count],
                fpr_query=cfg.fpr_query[hierarchy_count],
                output_file_one=one,
                output_file_all=all_,
            )
            hierarchy_count += 1
        else:
            levels[label].filters.append(spec)
    return dict(sorted(levels.items()))


def parse_reads_config(cfg: ClassifyConfig) -> dict[str, list[tuple[str, str]]]:
    """{prefix: [(file1, file2|""), ...]} (GanonClassify.cpp:289-351)."""
    rc: dict[str, list[tuple[str, str]]] = {}
    if cfg.batch_reads:
        for bf in cfg.batch_reads:
            with open(bf) as f:
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    if len(fields) < 2:
                        raise ValueError(
                            "invalid --batch-reads file (prefix\tfile1[\tfile2])"
                        )
                    f2 = fields[2] if len(fields) >= 3 else ""
                    rc.setdefault(fields[0], []).append((fields[1], f2))
    else:
        for rf in cfg.single_reads:
            rc.setdefault("", []).append((rf, ""))
        for i in range(0, len(cfg.paired_reads), 2):
            rc.setdefault("", []).append(
                (cfg.paired_reads[i], cfg.paired_reads[i + 1])
            )
    return rc


def load_tax(tax_file: str) -> dict[str, tuple[str, str, str]]:
    """.tax rows: target <tab> parent <tab> rank <tab> name [...]"""
    tax = {}
    with open(tax_file) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            tax[fields[0]] = (fields[1], fields[2], fields[3])
    return tax


# --------------------------------------------------------------------------
# stats containers


# max (reads x window positions) per uncompacted fallback count: bounds the
# plain version's [rows, M, W8] gather on the CPU for long reads
_FALLBACK_GATHER_ROWS = 2048 * 512

_TOTAL_FIELDS = (
    "input_seqs",
    "seqs_processed",
    "seqs_skipped_big",
    "seqs_skipped_small",
    "length_processed",
    "kmers_processed",
    "seqs_classified",
    "kmers_matches",
    "kmers_from_classified_seqs",
    "matches",
    "seqs_unique",
    "discarded_matches_filter",
    "discarded_matches_fprquery",
)


class Total:
    __slots__ = _TOTAL_FIELDS

    def __init__(self):
        for f in _TOTAL_FIELDS:
            setattr(self, f, 0)

    def add(self, other: "Total"):
        for f in _TOTAL_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))


class Rep:
    """Per-(prefix, target) report counters."""

    __slots__ = ("matches", "seqs_lca", "seqs_unique", "disc_filter", "disc_fpr")

    def __init__(self):
        self.matches = 0
        self.seqs_lca = 0
        self.seqs_unique = 0
        self.disc_filter = 0
        self.disc_fpr = 0


# --------------------------------------------------------------------------
# per-level classification context


class LevelContext:
    """Loaded filters + union target table + LCA for one hierarchy level
    (every filter sharded over ``mesh`` when one is given)."""

    def __init__(self, level: HierarchyLevel, cfg: ClassifyConfig,
                 mesh=None):
        self.level = level
        self.specs = level.filters
        self.filters = []
        taxes = []
        for spec in level.filters:
            self.filters.append(dev.load_device_filter(spec.ibf_file,
                                                       cfg.device, mesh))
            if spec.tax_file:
                taxes.append(load_tax(spec.tax_file))
        k = self.filters[0].ibf_config.kmer_size
        w = self.filters[0].ibf_config.window_size
        for f in self.filters[1:]:
            if f.ibf_config.kmer_size != k or f.ibf_config.window_size != w:
                raise ValueError(
                    "databases on the same hierarchy must share k-mer/window sizes"
                )
        self.kmer_size, self.window_size = k, w

        # union target table (deterministic: filter order, then target order)
        self.union_targets: list[str] = []
        index: dict[str, int] = {}
        self.filter_cols: list[np.ndarray] = []
        self.filter_fprs: list[np.ndarray] = []
        for f in self.filters:
            cols = np.empty(f.num_targets, dtype=np.int64)
            fprs = np.empty(f.num_targets, dtype=np.float64)
            for j, t in enumerate(f.targets):
                if t not in index:
                    index[t] = len(self.union_targets)
                    self.union_targets.append(t)
                cols[j] = index[t]
                fprs[j] = f.target_fpr[t]
            self.filter_cols.append(cols)
            self.filter_fprs.append(fprs)
        # the merge kernel's inverse column map on the filters' device,
        # built once a level
        self.filter_colmap = dev.merge_colmap(
            self.filter_cols, len(self.union_targets),
            self.filters[0].device)
        # per-filter fpr indexed by UNION column: the winning filter's fpr
        # rides with each match of a multi-filter level
        self.union_fprs: list[np.ndarray] = []
        for cols, fprs in zip(self.filter_cols, self.filter_fprs):
            u = np.zeros(len(self.union_targets), dtype=np.float64)
            u[cols] = fprs
            self.union_fprs.append(u)
        # level-scoped fpr-query threshold cache
        self.fpr_min = FprQueryMinCount(level.fpr_query)
        # adaptive compact-output width: start small and escalate to
        # cfg.top_k_matches when a batch overflows (sticky for the level)
        start_k = 4 if len(self.union_targets) >= 4096 else 32
        self.top_k_current = min(start_k, cfg.top_k_matches)
        # the ragged match stream's slots per read (device.ragged; the JAX
        # engine's default of 2): doubled, sticky, on a cap overflow, and
        # None (the dense layout) once they reach the top-K width
        self.match_slots: int | None = 2
        # the pruned pair cap as a fraction of the batch; raised by 0.5,
        # sticky, on a pair spill
        self.pair_frac: float = cfg.pruned_pair_frac
        # the fast path's result transfers: batches fetched in each
        # layout, cap overflows, pair-spill retries, and the bytes
        # fetched against the dense layout's bytes at the same B and K
        self.transfer = dict(ragged_batches=0, dense_batches=0,
                             cap_overflows=0, pair_spill_retries=0,
                             fetched_bytes=0, dense_bytes=0)

        # taxonomy: merge (first filter wins), add missing targets under root
        self.tax: dict[str, tuple[str, str, str]] = {}
        for t in reversed(taxes):
            self.tax.update(t)
        if self.tax:
            for t in self.union_targets:
                if t not in self.tax:
                    self.tax[t] = (cfg.tax_root_node, "no rank", t)
        # per-prefix [T] tally accumulators, folded into Rep objects once
        # at level end (_fold_tallies)
        self._tally: dict[str, dict[str, np.ndarray]] = {}
        self._lca_tally: dict[str, dict[str, int]] = {}
        self.lca: LCA | None = None
        self.union_lca_ids: np.ndarray | None = None
        if not cfg.skip_lca:
            if cfg.tax_root_node not in self.tax:
                raise ValueError(
                    f"root node [{cfg.tax_root_node}] not found (--tax-root-node)"
                )
            self.lca = build_lca(self.tax, cfg.tax_root_node)
            self.union_lca_ids = self.lca.encode_ids(self.union_targets)

    def tally(self, prefix: str) -> dict[str, np.ndarray]:
        t = self._tally.get(prefix)
        if t is None:
            T = len(self.union_targets)
            t = {
                k: np.zeros(T, np.int64)
                for k in ("matches", "seqs_unique", "disc_filter",
                          "disc_fpr")
            }
            self._tally[prefix] = t
        return t

    def lca_tally(self, prefix: str) -> dict[str, int]:
        d = self._lca_tally.get(prefix)
        if d is None:
            d = {}
            self._lca_tally[prefix] = d
        return d


def _fold_tallies(rep: dict, ctx: LevelContext) -> None:
    """Materialize the level's accumulated tallies into Rep objects
    (target order, then LCA nodes) before .rep writing."""
    for prefix, t in ctx._tally.items():
        nz = np.nonzero(
            t["matches"] | t["seqs_unique"] | t["disc_filter"]
            | t["disc_fpr"]
        )[0]
        for j in nz:
            r = rep.setdefault((prefix, ctx.union_targets[j]), Rep())
            r.matches += int(t["matches"][j])
            r.seqs_unique += int(t["seqs_unique"][j])
            r.disc_filter += int(t["disc_filter"][j])
            r.disc_fpr += int(t["disc_fpr"][j])
    for prefix, d in ctx._lca_tally.items():
        for node, n in d.items():
            rep.setdefault((prefix, node), Rep()).seqs_lca += n


# --------------------------------------------------------------------------
# main engine


class _Out:
    """Lazy per-prefix output file handles + a background writer thread.

    One writer thread drains submitted jobs in order, so line formatting
    and file I/O overlap the main thread's device waits; each job carries
    its submitter's trace root (spans ``writer.format``, ``writer.write``).
    Direct ``get().write()`` stays for the end-of-run writers (.rep/.sta).
    """

    _DONE = object()

    def __init__(self):
        import queue
        import threading

        self._files = {}
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._err = None

        def work():
            while True:
                job = self._q.get()
                try:
                    if job is self._DONE:
                        return
                    path, payload, token = job
                    with trace.within(token):
                        if callable(payload):
                            with trace.span("writer.format", cpu=False):
                                payload = payload()
                        if payload:
                            with trace.span("writer.write", cpu=False):
                                self._file(path).write(payload)
                except BaseException as e:  # surfaced on drain/close
                    if self._err is None:
                        self._err = e
                finally:
                    self._q.task_done()

        self._t = threading.Thread(target=work, name="ganon-writer",
                                   daemon=True)
        self._t.start()

    def _file(self, path: str, mode: str = "w"):
        with self._lock:
            if path not in self._files:
                self._files[path] = open(path, mode)
            return self._files[path]

    def get(self, path: str, mode: str = "w"):
        """Direct handle (create with ``mode`` on first touch)."""
        return self._file(path, mode)

    def submit(self, path: str, payload):
        """Queue a write: a string, or a zero-arg callable returning one
        (formatting then runs on the writer thread)."""
        token = trace.carry()
        with trace.span("finish.submit", cpu=False):
            self._q.put((path, payload, token))
        trace.high("writer.queue_max", self._q.qsize())
        if self._err is not None:
            self.drain()

    def drain(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close_all(self):
        self.drain()
        self._q.put(self._DONE)
        self._t.join()
        for f in self._files.values():
            f.close()
        self._files.clear()


def _check_device(cfg: ClassifyConfig) -> None:
    """Raise before any output when ``cfg.device`` is a card that is not
    there."""
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")


def _make_mesh(cfg: ClassifyConfig):
    """The run's (batch, bins) mesh over this process's devices of
    ``cfg.device``'s type, or None (``use_mesh`` off, one device).

    Local devices only: under ``--distributed`` each process classifies
    its own read shard (``parallel.multihost.shard_reads``) on its own
    mesh, so nothing crosses processes.
    """
    if not cfg.use_mesh:
        return None
    kind = torch.device(cfg.device).type
    devices = [d for d in pmesh.local_devices() if d.type == kind]
    if len(devices) < 2:
        return None
    mesh = pmesh.make_mesh(devices)
    if not cfg.quiet:
        print(f" - device mesh {dict(mesh.shape)} over {mesh.size} devices",
              file=sys.stderr)
    return mesh


class _Runner:
    """One hierarchy level in the cross-level scheduler."""

    __slots__ = (
        "li", "label", "level", "first", "last", "ctx", "rep", "coalescer",
        "source_done", "inflight", "complete", "ready", "one_files",
        "all_files", "finish_args",
    )

    def __init__(self, li: int, label: str, level: HierarchyLevel,
                 n_levels: int):
        self.li, self.label, self.level = li, label, level
        self.first = li == 0
        self.last = li == n_levels - 1
        self.ctx: LevelContext | None = None
        self.rep: dict = {}
        self.coalescer = None
        self.source_done = False
        self.inflight = 0
        self.complete = False
        self.ready: deque = deque()


# the returned ``timing``: its keys and the spans they read
_TIMING = (("input_wait", "engine.input_wait"),
           ("dispatch", "engine.dispatch"), ("fetch", "finish.fetch"),
           ("finish", "engine.finish"), ("total", "engine.run"))


def _walls(root) -> dict:
    spans = trace.totals([root])["spans"]
    return {k: spans[n]["wall_s"] if n in spans else 0.0
            for k, n in _TIMING}


def run_classify(cfg: ClassifyConfig) -> dict:
    """Run the full classification; returns collected stats (for tests).

    ``timing`` is the wall split of the run's spans: ``input_wait``
    (``engine.input_wait``), ``dispatch`` (``engine.dispatch``),
    ``finish`` (``engine.finish``, which holds ``fetch``,
    ``finish.fetch``'s wait for the device result) and ``total``
    (``engine.run``)."""
    with trace.span("engine.run") as run:
        before = _walls(run.root)
        stats = _run_classify(cfg, run)
    after = _walls(run.root)
    stats["timing"] = {k: after[k] - before[k] for k in after}
    return stats


def _run_classify(cfg: ClassifyConfig, run: trace.span) -> dict:
    cfg.validate()
    levels = parse_hierarchy(cfg)
    _check_device(cfg)
    reads_config = parse_reads_config(cfg)
    prefixes = list(reads_config.keys())
    mesh = _make_mesh(cfg)

    totals: dict[str, Total] = {p: Total() for p in prefixes}
    hierarchy_totals: dict[str, dict[str, Total]] = {
        lbl: {p: Total() for p in prefixes} for lbl in levels
    }

    out = _Out()
    for p in prefixes:
        out.get(cfg.output_prefix + p + ".rep")
        if cfg.output_unclassified:
            out.get(cfg.output_prefix + p + ".unc")

    # Cross-level scheduler (ganon_tpu.classify.engine.run_classify): every
    # level is a runner with its own ready queue; a level's leftovers
    # coalesce into the next level's batches as its batches finish, so the
    # next level dispatches while this one still has results in flight.
    # Lower levels have dispatch priority; a level completes (and writes
    # its .rep section) once its source is done and nothing of it is
    # queued or in flight.
    n_reads = cfg.n_reads or 8192  # run-local: never mutate the caller's config
    runners = [_Runner(li, label, levels[label], len(levels))
               for li, label in enumerate(levels)]

    def ensure_ctx(r: _Runner) -> LevelContext:
        if r.ctx is not None:
            return r.ctx
        with trace.span("engine.context", level=r.label):
            r.ctx = LevelContext(r.level, cfg, mesh)
        file_mode = "w" if (r.first or not cfg.output_single) else "a"
        r.one_files = {p: cfg.output_prefix + p + "." + r.level.output_file_one
                       for p in prefixes}
        r.all_files = {p: cfg.output_prefix + p + "." + r.level.output_file_all
                       for p in prefixes}
        if cfg.output_lca and not cfg.skip_lca:
            for p in prefixes:
                out.get(r.one_files[p], file_mode)
        if cfg.output_all:
            for p in prefixes:
                out.get(r.all_files[p], file_mode)
        r.finish_args = (r.ctx, cfg, r.rep, hierarchy_totals[r.label],
                         r.first, r.last, out, r.one_files, r.all_files)
        return r.ctx

    ensure_ctx(runners[0])

    def produce():
        for prefix, files in reads_config.items():
            for f1, f2 in files:
                yield from encoded_batches(f1, f2, prefix, n_reads)

    stream = produce()
    if cfg.read_stride > 1:
        stream = strided_batches(stream, cfg.read_stride, cfg.read_offset)
    if cfg.length_bucketing:
        stream = bucketed_batches(stream, n_reads, bp_budget=n_reads * 1024)
    lvl0 = iter(ThreadedBatchSource(stream))

    depth = max(1, cfg.pipeline_depth)
    pending: deque = deque()  # (runner, batch, disp) in dispatch order

    def route_leftover(r: _Runner, lo) -> None:
        if lo is None or not len(lo):
            return
        nxt = runners[r.li + 1]
        if cfg.length_bucketing:
            # leftovers are ragged sub-batches: coalesce them back to full
            # batches, re-bucketed by length
            if nxt.coalescer is None:
                nxt.coalescer = BatchCoalescer(n_reads,
                                               bp_budget=n_reads * 1024)
            nxt.ready.extend(nxt.coalescer.add(lo))
        else:
            nxt.ready.append(lo)

    def maybe_complete(r: _Runner) -> None:
        while (not r.complete and r.source_done and not r.inflight
               and not r.ready):
            r.complete = True
            # fold per-level totals and reports into the global stats
            for p in prefixes:
                t = hierarchy_totals[r.label][p]
                tt = totals[p]
                for fld in _TOTAL_FIELDS:
                    if fld != "input_seqs":
                        setattr(tt, fld, getattr(tt, fld) + getattr(t, fld))
            if r.ctx is not None:
                with trace.span("engine.rep", level=r.label):
                    _fold_tallies(r.rep, r.ctx)
                    _write_rep(r.rep, r.ctx, cfg, r.label, out)
            if r.li + 1 >= len(runners):
                return
            nxt = runners[r.li + 1]
            if nxt.coalescer is not None:
                nxt.ready.extend(nxt.coalescer.flush())
            nxt.source_done = True
            r = nxt

    def finish_oldest() -> None:
        r, batch, disp = pending.popleft()
        with trace.span("engine.finish", cpu=False, level=r.label,
                        reads=len(batch)):
            lo = _finish_batch_fast((batch, disp), *r.finish_args)
        if not r.last:
            route_leftover(r, lo)
        r.inflight -= 1
        maybe_complete(r)

    def next_ready():
        """(runner, batch) to dispatch next, or None when nothing is ready;
        the batch counts as in flight from the moment it leaves a queue."""
        r0 = runners[0]
        if not r0.source_done:
            with trace.span("engine.input_wait", cpu=False):
                batch = next(lvl0, None)
            if batch is not None:
                totals[batch.prefix].input_seqs += len(batch)
                trace.count("engine.reads", len(batch))
                trace.count("engine.bases", int(batch.len1.sum()) + (
                    int(batch.len2.sum()) if batch.paired else 0))
                r0.inflight += 1
                return r0, batch
            r0.source_done = True
            maybe_complete(r0)
        for r in runners:
            if r.ready:
                r.inflight += 1
                return r, r.ready.popleft()
        return None

    while True:
        nb = next_ready()
        if nb is None:
            if pending:
                finish_oldest()
                continue
            break
        r, batch = nb
        ctx = ensure_ctx(r)
        trace.count("engine.batches")
        with trace.span("engine.dispatch", cpu=False, level=r.label,
                        reads=len(batch)):
            disp = _dispatch_batch_fast(batch, ctx, cfg)
        if disp is None:
            while pending:
                finish_oldest()
            with trace.span("engine.finish", cpu=False, level=r.label,
                            reads=len(batch)):
                lo = _exact(batch, r.finish_args)
            if not r.last:
                route_leftover(r, lo)
            r.inflight -= 1
            maybe_complete(r)
        else:
            if len(pending) >= depth:
                finish_oldest()
            pending.append((r, batch, disp))

    with trace.span("engine.rep"):
        # .rep totals trailer
        for p in prefixes:
            f = out.get(cfg.output_prefix + p + ".rep")
            f.write(f"#total_classified\t{totals[p].seqs_classified}\n")
            f.write(
                f"#total_unclassified\t{totals[p].input_seqs - totals[p].seqs_classified}\n"
            )

    with trace.span("engine.drain"):
        out.close_all()

    if cfg.output_stats:
        with trace.span("engine.rep"):
            _write_stats(cfg, totals, hierarchy_totals, levels, prefixes)

    if not cfg.quiet:
        _print_stats(totals, elapsed=run.elapsed_s())

    return {
        "totals": totals,
        "hierarchy_totals": hierarchy_totals,
        # per level: the result transfers and the final ragged slots
        "transfer": {r.label: dict(r.ctx.transfer,
                                   match_slots=r.ctx.match_slots,
                                   pair_frac=r.ctx.pair_frac)
                     for r in runners if r.ctx is not None},
    }


def _dispatch_batch_fast(batch: EncodedBatch, ctx: LevelContext,
                         cfg: ClassifyConfig):
    """Enqueue one batch's kernels and its result copy. Returns the
    in-flight host copy + unpack dims, or None when the level has no fast
    path (device thresholding off, a level mixing a forest or a raptor
    archive with other filters, a union wider than 0xFFFF, a pruned
    forest of more than 0xFFFF groups, a pruned forest or a level of
    several filters under a ``hashes_limit`` above 0xFFFF): the batch
    then takes :func:`_classify_batch`. A flat filter, forest or raptor
    archive past either 16-bit bound takes ``select``'s 32-bit mode."""
    if not cfg.device_thresholding:
        return None
    if len(ctx.filters) != 1:
        return _dispatch_batch_fast_multi(batch, ctx, cfg)
    f = ctx.filters[0]
    is_forest = isinstance(f, dev.DeviceHIBF) and f.contiguous and f.subs
    is_raptor = isinstance(f, dev.DeviceRaptorHIBF) and f.subs
    is_pruned = isinstance(f, dev.DevicePrunedForest)
    if is_pruned and (f.num_groups > 0xFFFF or cfg.hashes_limit > 0xFFFF):
        # group ids travel as u16 halves of the group words, and lanes
        # mode packs counts into 16 bits
        return None
    if not (isinstance(f, dev.DeviceFilter) or is_forest or is_raptor
            or is_pruned):
        return None
    batch_pad = _round_up(dev.bucket_len(len(batch), minimum=64),
                          f.batch_mult)
    with trace.span("dispatch.pack", cpu=False):
        inbuf, L1, L2 = dev.pack_batch_direct(batch, batch_pad)
    inbuf_d = f.put_batch(inbuf)
    # per-batch [T] matches_t is only consumed when fpr-query is off
    emit_mt = ctx.level.fpr_query >= 1.0
    pinfo = None
    if is_pruned:
        # matches are lane ids (slot * gs + lane), mapped on the host
        S = cfg.pruned_max_groups
        K = min(ctx.top_k_current, S * f.group_size)
        pack16 = True  # lane ids fit 16 bits
        cap = _match_cap(ctx, batch_pad, K, pack16)
        pair_cap = 0
        if ctx.pair_frac > 0 and S > 1:
            # a multiple of 256 (the JAX engine's rule, which kept its
            # compiled programs few); the device ignores caps >= B * S
            pair_cap = min(-(-int(batch_pad * ctx.pair_frac) // 256) * 256,
                           batch_pad * S)
        with trace.span("dispatch.enqueue", cpu=False):
            packed = dev.classify_batch_packed_pruned(
                f, inbuf_d, ctx.specs[0].rel_cutoff, ctx.level.rel_filter,
                cfg.hashes_limit, k=ctx.kmer_size, w=ctx.window_size, L1=L1,
                L2=L2, max_groups=S, top_k=K, emit_matches_t=emit_mt,
                match_cap=cap, pair_cap=pair_cap,
            )
        pinfo = (S, f.group_size, -(-S // 2),
                 0 < pair_cap < batch_pad * S)
    else:
        # flat, forest and raptor alike: f.counts is the filter's own count
        K = min(ctx.top_k_current, f.num_targets)
        pack16 = f.num_targets <= 0xFFFF and cfg.hashes_limit <= 0xFFFF
        cap = _match_cap(ctx, batch_pad, K, pack16)
        with trace.span("dispatch.enqueue", cpu=False):
            packed = dev.classify_batch_packed(
                f, inbuf_d, ctx.specs[0].rel_cutoff, ctx.level.rel_filter,
                cfg.hashes_limit, k=ctx.kmer_size, w=ctx.window_size, L1=L1,
                L2=L2, top_k=K, emit_matches_t=emit_mt, pack16=pack16,
                match_cap=cap,
            )
    return (_start_host_copy(packed), batch_pad, K, f.num_targets, emit_mt,
            False, pinfo, pack16, cap)


def _match_cap(ctx: LevelContext, batch_pad: int, K: int,
               pack16: bool) -> int:
    """The ragged stream's cap, ``batch_pad * match_slots`` (the JAX
    engine's rule), or 0 for the dense layout: without pack16, with the
    slots escalated to dense, or when dense is no larger."""
    if not pack16 or ctx.match_slots is None:
        return 0
    cap = batch_pad * ctx.match_slots
    return 0 if cap >= batch_pad * K else cap


def _dispatch_batch_fast_multi(batch: EncodedBatch, ctx: LevelContext,
                               cfg: ClassifyConfig):
    """The fast path of a level with several flat filters (per-filter
    cutoffs, union merge and winners on the card). None when a filter is
    not a flat IBF, or the union or ``hashes_limit`` exceeds the 16-bit
    packed layout (the winners ride only beside it)."""
    if not all(type(f) is dev.DeviceFilter for f in ctx.filters):
        return None
    U = len(ctx.union_targets)
    if U > 0xFFFF or cfg.hashes_limit > 0xFFFF:
        return None
    batch_pad = _round_up(dev.bucket_len(len(batch), minimum=64),
                          max(f.batch_mult for f in ctx.filters))
    with trace.span("dispatch.pack", cpu=False):
        inbuf, L1, L2 = dev.pack_batch_direct(batch, batch_pad)
    inbuf_d = ctx.filters[0].put_batch(inbuf)
    K = min(ctx.top_k_current, U)
    emit_mt = ctx.level.fpr_query >= 1.0
    cap = _match_cap(ctx, batch_pad, K, True)
    with trace.span("dispatch.enqueue", cpu=False):
        packed = dev.classify_batch_packed_multi(
            ctx.filters, ctx.filter_colmap, inbuf_d,
            [s.rel_cutoff for s in ctx.specs], ctx.level.rel_filter,
            cfg.hashes_limit, k=ctx.kmer_size, w=ctx.window_size, L1=L1,
            L2=L2, num_union=U, top_k=K, emit_matches_t=emit_mt,
            match_cap=cap,
        )
    return (_start_host_copy(packed), batch_pad, K, U, emit_mt, True, None,
            True, cap)


def _round_up(batch_pad: int, mult: int) -> int:
    """``batch_pad`` rounded up to a multiple of the mesh's batch axis
    (``put_batch`` splits the rows over it)."""
    return -(-batch_pad // mult) * mult


def _start_host_copy(packed: torch.Tensor):
    """Enqueue the device->host copy now into pinned memory, with an event
    marking its completion; :func:`_fetch` waits on the event (reading
    the buffer before it would return stale bytes)."""
    with trace.span("dispatch.copy", cpu=False):
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))
    return host, done


def _fetch(handle) -> np.ndarray:
    """The host copy of a packed result, once its copy has completed."""
    host, done = handle
    with trace.span("finish.fetch", cpu=False):
        if done is not None:
            done.synchronize()
    return host.numpy()


def _finish_batch_fast(pending, ctx, cfg, rep, level_totals, first, last,
                       out, one_files, all_files):
    """Fetch + finish an in-flight batch; escalates the ragged stream's
    slots on a cap overflow and the compact width on top-K overflow (both
    sticky for the level), retries a pruned batch whose pairs spilled
    past the pair cap once with dense slots (and raises the level's cap),
    falls back to the exact full path on compaction overflow (and on a
    pruned forest's group overflow: the exact path counts every group).
    Returns the leftover (unclassified) reads unless the level is the
    last."""
    batch, (handle, B_pad, K, T, emit_mt, has_win, pinfo, pack16,
            cap) = pending
    B0 = len(batch)
    n_extra = pinfo[2] if pinfo else 0
    fin = (ctx, cfg, rep, level_totals, first, last, out, one_files,
           all_files)
    tr = ctx.transfer
    tr["ragged_batches" if cap > 0 else "dense_batches"] += 1
    fetched = handle[0].numel() * 4
    dense = 4 * (B_pad * K * (2 if has_win or not pack16 else 1)
                 + (4 + n_extra) * B_pad + T * (2 if emit_mt else 1) + 3)
    tr["fetched_bytes"] += fetched
    tr["dense_bytes"] += dense
    trace.count("transfer.d2h_bytes", fetched)
    trace.count("transfer.dense_bytes", dense)

    def redispatch(cause, pair_frac=None):
        """Dispatch the batch again (at ``pair_frac`` instead of the
        level's pair fraction when given) and finish it (the exact path
        when the level has no fast path)."""
        trace.count("engine.redispatches")
        with trace.span("finish.redispatch", cpu=False, cause=cause):
            if pair_frac is None:
                disp = _dispatch_batch_fast(batch, ctx, cfg)
            else:
                saved, ctx.pair_frac = ctx.pair_frac, pair_frac
                disp = _dispatch_batch_fast(batch, ctx, cfg)
                ctx.pair_frac = saved
            if disp is None:
                return _exact(batch, fin)
            return _finish_batch_fast((batch, disp), *fin)

    if cap > 0:
        packed = _fetch(handle)
        with trace.span("finish.unpack", cpu=False):
            res = dev.unpack_batch_result_ragged(
                packed, B_pad, cap, T, K, has_win, n_extra=n_extra,
                has_matches_t=emit_mt)
        if res["cap_overflow"]:
            # the stream outgrew the cap: double the slots per read
            # (sticky; the dense layout once they reach K) and re-dispatch.
            # A pipelined batch may land after a newer one went dense: the
            # ragged layout just proven too small is never brought back.
            total = int(np.minimum(res["n_matches"], K).sum())
            need = -(-total // max(B_pad, 1)) + 1
            if ctx.match_slots is not None:
                ctx.match_slots = max(ctx.match_slots * 2, need)
                if ctx.match_slots >= K:
                    ctx.match_slots = None
            tr["cap_overflows"] += 1
            return redispatch("cap")
    else:
        packed = _fetch(handle)
        with trace.span("finish.unpack", cpu=False):
            res = dev.unpack_batch_result(packed, B_pad, K, T,
                                          has_matches_t=emit_mt,
                                          has_win=has_win, n_extra=n_extra,
                                          pack16=pack16)
    if not res["overflow"][:B0].any() and (
        res["n_matches"][:B0] > K
    ).any() and ctx.top_k_current < cfg.top_k_matches:
        # matches exceeded the adaptive compact width: widen to the
        # configured cap and re-dispatch this batch
        ctx.top_k_current = cfg.top_k_matches
        return redispatch("top_k")
    if (res["overflow"][:B0].any()
            or (res["n_matches"][:B0] > K).any()):
        if pinfo is not None and pinfo[3] and res["overflow"][:B0].any():
            # an overflow under the pair cap may be a pair spill: retry
            # once with dense slots (exact) and raise the level's cap
            # (sticky), so a spilling workload converges to dense; a true
            # overflow (groups past S, compaction) survives the dense
            # retry and takes the exact path below
            tr["pair_spill_retries"] += 1
            ctx.pair_frac += 0.5
            return redispatch("pair_spill", pair_frac=0.0)
        return _exact(batch, fin)
    if pinfo is not None:
        with trace.span("finish.unpack", cpu=False):
            # pruned matches carry lane ids (slot * gs + lane): rebuild
            # each read's chosen groups from its u16 group words and map
            # to global targets; entries past n_matches are clamped
            # (every consumer masks by n_matches)
            S, gs = pinfo[0], pinfo[1]
            gsel = np.empty((B_pad, S), np.int64)
            for i, wd in enumerate(res["extra_rows"]):
                gsel[:, 2 * i] = wd & 0xFFFF
                if 2 * i + 1 < S:
                    gsel[:, 2 * i + 1] = wd >> 16
            lanes = res["top_idx"]
            slot = np.minimum(lanes // gs, S - 1)
            g = np.take_along_axis(gsel, slot, axis=1)
            res["top_idx"] = np.minimum(g * gs + lanes % gs, T - 1).astype(
                np.int32)
    nh = res["n_hashes"][:B0].astype(np.int64)
    l1 = batch.len1.astype(np.int64)
    l2 = (batch.len2.astype(np.int64) if batch.paired
          else np.zeros(B0, np.int64))
    with trace.span("finish.assign", cpu=False):
        return _finish_batch_compact(batch, *fin, res, nh, l1, l2)


def _exact(batch, fin):
    """The exact path of a batch the fast path could not finish."""
    trace.count("engine.exact_batches")
    with trace.span("finish.exact", cpu=False, reads=len(batch)):
        return _classify_batch(batch, *fin)


def _classify_batch(
    batch: EncodedBatch,
    ctx: LevelContext,
    cfg: ClassifyConfig,
    rep: dict,
    level_totals: dict[str, Total],
    first: bool,
    last: bool,
    out: _Out,
    one_files: dict,
    all_files: dict,
) -> EncodedBatch | None:
    """Classify one batch exactly at one level: uncompacted hashes (no
    overflow), then, for a single filter, device thresholds with the
    configured top-K, or else (several filters, top-K overflow, device
    thresholding off) the full-matrix host path with the per-filter
    cutoffs and the strict-greater union merge. Returns the leftover
    (unclassified) reads unless the level is the last."""
    B0 = len(batch)
    w = ctx.window_size
    f0 = ctx.filters[0]
    batch_pad = dev.bucket_len(B0, minimum=64)
    inbuf, L1, L2 = dev.pack_batch_direct(batch, batch_pad)
    hashes, n_hashes_d, _ = dev.extract_hashes(
        torch.from_numpy(inbuf).to(f0.device), k=ctx.kmer_size, w=w,
        L1=L1, L2=L2,
    )
    # bound the plain count's [rows, M, W8] gather for long reads
    Bp, M = hashes.shape
    step = Bp
    if M > 2048:
        step = max(1, min(Bp, _FALLBACK_GATHER_ROWS // M))

    def counts(f, spec, h, n):
        # a pruned forest applies its coarse gate (its defined semantics),
        # so this path equals its fast path
        if isinstance(f, dev.DevicePrunedForest):
            return f.counts_gated(h, n, spec.rel_cutoff)
        return f.counts(h, n)

    counts_dev = [
        torch.cat([
            counts(f, spec, hashes[i:i + step], n_hashes_d[i:i + step])
            for i in range(0, Bp, step)
        ])
        for f, spec in zip(ctx.filters, ctx.specs)
    ]
    nh = n_hashes_d.cpu().numpy()[:B0].astype(np.int64)
    l1 = batch.len1.astype(np.int64)
    l2 = (
        batch.len2.astype(np.int64)
        if batch.paired
        else np.zeros(B0, np.int64)
    )

    # single filter: thresholds + top-K compaction on the card, in the
    # 32-bit mode past either 16-bit bound (JAX's sort16 rule)
    if len(ctx.filters) == 1 and cfg.device_thresholding:
        emit_mt = ctx.level.fpr_query >= 1.0
        K = min(cfg.top_k_matches, f0.num_targets)
        pack16 = f0.num_targets <= 0xFFFF and cfg.hashes_limit <= 0xFFFF
        packed = dev.select(
            counts_dev[0], n_hashes_d,
            torch.zeros_like(n_hashes_d, dtype=torch.uint8),
            ctx.specs[0].rel_cutoff, ctx.level.rel_filter, cfg.hashes_limit,
            top_k=cfg.top_k_matches, emit_matches_t=emit_mt, pack16=pack16,
        )
        res = dev.unpack_batch_result(
            packed.cpu().numpy(), Bp, K, f0.num_targets,
            has_matches_t=emit_mt, pack16=pack16,
        )
        if not (res["n_matches"][:B0] > K).any():
            return _finish_batch_compact(
                batch, ctx, cfg, rep, level_totals, first, last, out,
                one_files, all_files, res, nh, l1, l2,
            )
        # top-K overflow: fall through to the full-matrix path

    counts_list = [c.cpu().numpy()[:B0].astype(np.int64) for c in counts_dev]

    small = l1 < w
    big = (~small) & (nh > cfg.hashes_limit)
    ok = (~small) & (~big)

    tot = level_totals[batch.prefix]
    if first:
        tot.seqs_skipped_small += int(small.sum())
        tot.seqs_skipped_big += int(big.sum())
        tot.seqs_processed += int(ok.sum())
        tot.length_processed += int((l1 + l2)[ok].sum())
        tot.kmers_processed += int(nh[ok].sum())

    # per-filter cutoff, then the strict-greater union merge (the first
    # filter wins ties; the winner's fpr rides with the count)
    U = len(ctx.union_targets)
    union_counts = np.zeros((B0, U), dtype=np.int64)
    union_fpr = np.zeros((B0, U), dtype=np.float64)
    for fi, counts in enumerate(counts_list):
        cutoff = np.maximum(np.ceil(nh * ctx.specs[fi].rel_cutoff),
                            1).astype(np.int64)
        kept = (counts >= cutoff[:, None]) & ok[:, None]
        uf = np.zeros((B0, U), dtype=np.int64)
        uf[:, ctx.filter_cols[fi]] = np.where(kept, counts, 0)
        better = uf > union_counts
        union_counts = np.where(better, uf, union_counts)
        union_fpr = np.where(better, ctx.union_fprs[fi][None, :], union_fpr)

    kept_any = union_counts > 0
    max_count = union_counts.max(axis=1)
    with np.errstate(invalid="ignore"):
        min_kept = np.where(kept_any, union_counts, np.iinfo(np.int64).max).min(axis=1)
    min_count = np.minimum(nh, min_kept)

    rel_filter = ctx.level.rel_filter
    threshold_filter = max_count - np.ceil((max_count - min_count) * rel_filter)
    pass_filter = kept_any & (union_counts >= threshold_filter[:, None])

    # rel-filter discards
    disc_f = kept_any & ~pass_filter
    prefix = batch.prefix
    tal = ctx.tally(prefix)
    T = len(ctx.union_targets)

    if disc_f.any():
        tal["disc_filter"] += disc_f.sum(axis=0)[:T]
        tot.discarded_matches_filter += int(disc_f.sum())

    # fpr-query filter: vectorized count-threshold comparison
    final = pass_filter
    if ctx.level.fpr_query < 1.0:
        ii, jj = np.nonzero(pass_filter)
        if len(ii):
            cmin = ctx.fpr_min.min_count_arr(nh[ii], union_fpr[ii, jj])
            drop = union_counts[ii, jj] < cmin
            final = pass_filter.copy()
            final[ii[drop], jj[drop]] = False
            disc_q = pass_filter & ~final
            if disc_q.any():
                tal["disc_fpr"] += disc_q.sum(axis=0)[:T]
                tot.discarded_matches_fprquery += int(disc_q.sum())

    classified = final.any(axis=1)
    n_matches = final.sum(axis=1)

    tot.seqs_classified += int(classified.sum())
    tot.kmers_from_classified_seqs += int(nh[classified].sum())
    tot.kmers_matches += int(max_count[classified].sum())
    tot.matches += int(n_matches.sum())
    tot.seqs_unique += int((classified & (n_matches == 1)).sum())

    tal["matches"] += final.sum(axis=0)[:T]

    tn = ctx.union_targets
    ids = batch.ids
    uniq_rows = np.nonzero(classified & (n_matches == 1))[0]
    multi_rows = np.nonzero(classified & (n_matches > 1))[0]

    if len(uniq_rows):
        u_t = np.argmax(final[uniq_rows], axis=1)
        tal["seqs_unique"] += np.bincount(u_t, minlength=T)[:T]
    lca_of: list[str] = []
    if len(multi_rows):
        ltal = ctx.lca_tally(prefix)
        if not cfg.skip_lca:
            # batched per-row LCA: left-align each row's match columns,
            # then one RMQ per read (lca.lca_rows)
            F = final[multi_rows]
            order = np.argsort(~F, axis=1, kind="stable")
            nm = n_matches[multi_rows].astype(np.int32)
            cols = order[:, : int(nm.max())]
            lca_ids = ctx.lca.lca_rows(ctx.union_lca_ids[cols], nm)
            lj, ln_ = np.unique(lca_ids, return_counts=True)
            names = [ctx.lca.decode_id(int(i)) for i in lj]
            for name, n in zip(names, ln_):
                ltal[name] = ltal.get(name, 0) + int(n)
            if cfg.output_lca:
                remap = {int(i): nm_ for i, nm_ in zip(lj, names)}
                lca_of = [remap[int(i)] for i in lca_ids]
        else:
            ltal[cfg.tax_root_node] = (
                ltal.get(cfg.tax_root_node, 0) + len(multi_rows)
            )

    if cfg.output_all:
        ai, aj = np.nonzero(final)
        a_v = union_counts[ai, aj]

        def _fmt_all(ai=ai, aj=aj, a_v=a_v, ids=ids, tn=tn):
            return "".join(
                f"{ids[i]}\t{tn[j]}\t{v}\n"
                for i, j, v in zip(ai.tolist(), aj.tolist(), a_v.tolist())
            )

        out.submit(all_files[prefix], _fmt_all)
    if cfg.output_lca and not cfg.skip_lca:
        u_j = (
            np.argmax(final[uniq_rows], axis=1)
            if len(uniq_rows) else np.empty(0, np.int64)
        )
        u_v = (
            union_counts[uniq_rows, u_j]
            if len(uniq_rows) else np.empty(0, np.int64)
        )
        m_c = max_count[multi_rows]

        def _fmt_one(uniq_rows=uniq_rows, u_j=u_j, u_v=u_v,
                     multi_rows=multi_rows, lca_of=lca_of, m_c=m_c,
                     ids=ids, tn=tn):
            parts = [
                f"{ids[i]}\t{tn[j]}\t{v}\n"
                for i, j, v in zip(
                    uniq_rows.tolist(), u_j.tolist(), u_v.tolist()
                )
            ]
            parts += [
                f"{ids[i]}\t{t}\t{c}\n"
                for i, t, c in zip(multi_rows.tolist(), lca_of, m_c.tolist())
            ]
            return "".join(parts)

        out.submit(one_files[prefix], _fmt_one)

    left = np.nonzero(~classified)[0]
    if last:
        if cfg.output_unclassified and len(left):
            out.submit(
                cfg.output_prefix + prefix + ".unc",
                lambda left=left, ids=ids: "".join(
                    ids[i] + "\n" for i in left.tolist()
                ),
            )
        return None
    return batch.select(left.astype(np.int64))


def _finish_batch_compact(
    batch, ctx, cfg, rep, level_totals, first, last, out, one_files,
    all_files, res, nh, l1, l2,
) -> EncodedBatch | None:
    """Host finish for the device-thresholded compact path; returns the
    leftover (unclassified) reads unless the level is the last."""
    B0 = len(batch)
    w = ctx.window_size
    prefix = batch.prefix
    tot = level_totals[prefix]

    small = l1 < w
    big = (~small) & (nh > cfg.hashes_limit)
    ok = (~small) & (~big)
    if first:  # leftovers were counted as processed at the first level
        tot.seqs_skipped_small += int(small.sum())
        tot.seqs_skipped_big += int(big.sum())
        tot.seqs_processed += int(ok.sum())
        tot.length_processed += int((l1 + l2)[ok].sum())
        tot.kmers_processed += int(nh[ok].sum())

    top_vals = res["top_vals"][:B0].copy()
    top_idx = res["top_idx"][:B0].copy()
    n_matches = res["n_matches"][:B0].astype(np.int64).copy()
    max_count = res["max_count"][:B0].astype(np.int64)

    tal = ctx.tally(prefix)
    T = len(ctx.union_targets)

    # rel-filter discards (device tally; unaffected by fpr-query)
    tal["disc_filter"] += res["disc_t"]
    tot.discarded_matches_filter += int(res["disc_t"].sum())

    if ctx.level.fpr_query < 1.0:
        # vectorized: min passing count per (n_hashes, fpr) pair, then
        # one array comparison + stable left-compaction of survivors
        Kc = top_vals.shape[1]
        valid = np.arange(Kc)[None, :] < n_matches[:, None]
        # a multi-filter level: the winning filter's fpr (reference
        # GanonClassify.cpp:533); a single filter: its own
        top_win = res.get("top_win")
        if top_win is not None:
            fpr_mat = np.stack(ctx.union_fprs)[top_win[:B0], top_idx]
        else:
            fpr_mat = ctx.union_fprs[0][top_idx]
        ii, jj = np.nonzero(valid)
        if len(ii):
            cmin = ctx.fpr_min.min_count_arr(nh[ii], fpr_mat[ii, jj])
            keep = valid.copy()
            keep[ii, jj] = top_vals[ii, jj] >= cmin
            disc = valid & ~keep
            if disc.any():
                tal["disc_fpr"] += np.bincount(top_idx[disc],
                                               minlength=T)[:T]
                tot.discarded_matches_fprquery += int(disc.sum())
                order = np.argsort(~keep, axis=1, kind="stable")
                top_idx = np.take_along_axis(top_idx, order, axis=1)
                top_vals = np.take_along_axis(top_vals, order, axis=1)
                n_matches = keep.sum(axis=1).astype(np.int64)
        classified = n_matches > 0
        tot.seqs_classified += int(classified.sum())
        tot.kmers_from_classified_seqs += int(nh[classified].sum())
        tot.kmers_matches += int(max_count[classified].sum())
        tot.matches += int(n_matches.sum())
        tot.seqs_unique += int((n_matches == 1).sum())
        vkeep = np.arange(top_vals.shape[1])[None, :] < n_matches[:, None]
        tal["matches"] += np.bincount(top_idx[vkeep], minlength=T)[:T]
    else:
        classified = n_matches > 0
        tot.seqs_classified += int(res["seqs_classified"])
        tot.kmers_from_classified_seqs += int(res["kmers_from_classified"])
        tot.kmers_matches += int(res["kmers_matches"])
        tot.matches += int(n_matches.sum())
        tot.seqs_unique += int((n_matches == 1).sum())
        tal["matches"] += res["matches_t"]

    # vectorized finish: bincount accounting + deferred line formatting
    # on the writer thread (overlaps the next batch's device wait)
    tn = ctx.union_targets
    ids = batch.ids
    uniq_rows = np.nonzero(n_matches == 1)[0]
    multi_rows = np.nonzero(n_matches > 1)[0]

    if len(uniq_rows):
        tal["seqs_unique"] += np.bincount(top_idx[uniq_rows, 0],
                                          minlength=T)[:T]
    lca_of: list[str] = []
    if len(multi_rows):
        ltal = ctx.lca_tally(prefix)
        if not cfg.skip_lca:
            # batched per-row LCA (one RMQ per read, no Python fold)
            lca_ids = ctx.lca.lca_rows(
                ctx.union_lca_ids[top_idx[multi_rows]],
                n_matches[multi_rows],
            )
            lj, ln_ = np.unique(lca_ids, return_counts=True)
            names = [ctx.lca.decode_id(int(i)) for i in lj]
            for name, n in zip(names, ln_):
                ltal[name] = ltal.get(name, 0) + int(n)
            if cfg.output_lca:
                remap = {int(i): nm for i, nm in zip(lj, names)}
                lca_of = [remap[int(i)] for i in lca_ids]
        else:
            ltal[cfg.tax_root_node] = (
                ltal.get(cfg.tax_root_node, 0) + len(multi_rows)
            )

    if cfg.output_all:
        vmask = np.arange(top_vals.shape[1])[None, :] < n_matches[:, None]
        ai, aj = np.nonzero(vmask)
        a_t = top_idx[ai, aj]
        a_v = top_vals[ai, aj]

        def _fmt_all(ai=ai, a_t=a_t, a_v=a_v, ids=ids, tn=tn):
            return "".join(
                f"{ids[i]}\t{tn[t]}\t{v}\n"
                for i, t, v in zip(ai.tolist(), a_t.tolist(), a_v.tolist())
            )

        out.submit(all_files[prefix], _fmt_all)
    if cfg.output_lca and not cfg.skip_lca:
        u_t = top_idx[uniq_rows, 0] if len(uniq_rows) else uniq_rows
        u_v = top_vals[uniq_rows, 0] if len(uniq_rows) else uniq_rows
        m_c = max_count[multi_rows]

        def _fmt_one(uniq_rows=uniq_rows, u_t=u_t, u_v=u_v,
                     multi_rows=multi_rows, lca_of=lca_of, m_c=m_c,
                     ids=ids, tn=tn):
            parts = [
                f"{ids[i]}\t{tn[t]}\t{v}\n"
                for i, t, v in zip(
                    uniq_rows.tolist(), u_t.tolist(), u_v.tolist()
                )
            ]
            parts += [
                f"{ids[i]}\t{t}\t{c}\n"
                for i, t, c in zip(multi_rows.tolist(), lca_of, m_c.tolist())
            ]
            return "".join(parts)

        out.submit(one_files[prefix], _fmt_one)

    left = np.nonzero(n_matches == 0)[0]
    if last:
        if cfg.output_unclassified and len(left):
            out.submit(
                cfg.output_prefix + prefix + ".unc",
                lambda left=left, ids=ids: "".join(
                    ids[i] + "\n" for i in left.tolist()
                ),
            )
        return None
    return batch.select(left.astype(np.int64))


def _write_rep(rep, ctx: LevelContext, cfg: ClassifyConfig, label, out: _Out):
    """Write one level's .rep rows (GanonClassify.cpp:834-853)."""
    by_prefix: dict[str, list] = {}
    for (prefix, target), r in rep.items():
        if r.matches or r.seqs_lca or r.seqs_unique:
            by_prefix.setdefault(prefix, []).append((target, r))
    for prefix, items in by_prefix.items():
        f = out.get(cfg.output_prefix + prefix + ".rep")
        for target, r in items:
            line = f"{label}\t{target}\t{r.matches}\t{r.seqs_unique}\t{r.seqs_lca}"
            if ctx.tax:
                node = ctx.tax.get(target, (cfg.tax_root_node, "no rank", target))
                line += f"\t{node[1]}\t{node[2]}"
            f.write(line + "\n")


def _write_stats(cfg, totals, hierarchy_totals, levels, prefixes):
    """.sta TSV, 18 columns per hierarchy + -total- row
    (GanonClassify.cpp:1130-1218)."""
    header = [
        "prefix", "hierarchy_label", "seq_processed", "seq_unclassified",
        "seq_classified", "seq_classified_perc", "seq_unique_matches",
        "seq_unique_matches_perc", "seq_multiple_matches",
        "seq_multiple_matches_perc", "matches", "avg_matches_ref_seq",
        "dis_matches_rel_filter", "dis_matches_fpr_query", "kmers_proccessed",
        "kmers_matched", "kmers_from_classified_seqs", "kmers_matched_perc",
    ]
    for p in prefixes:
        total = totals[p]
        seq_unclassified = total.seqs_processed - total.seqs_classified
        seq_processed = float(total.seqs_processed) if total.seqs_processed else 1.0
        with open(cfg.output_prefix + p + ".sta", "w") as f:
            f.write("\t".join(header) + "\n")

            def row(t: Total, label: str):
                smm = t.seqs_classified - t.seqs_unique
                avg = t.matches / t.seqs_classified if t.seqs_classified else 0
                kperc = (
                    (t.kmers_matches / t.kmers_from_classified_seqs) * 100
                    if t.kmers_matches
                    else 0
                )
                cols = [
                    p, label, int(seq_processed), seq_unclassified,
                    t.seqs_classified,
                    f"{(t.seqs_classified / seq_processed) * 100:.6f}",
                    t.seqs_unique,
                    f"{(t.seqs_unique / seq_processed) * 100:.6f}",
                    smm,
                    f"{(smm / seq_processed) * 100:.6f}",
                    t.matches,
                    f"{avg:.6f}",
                    t.discarded_matches_filter,
                    t.discarded_matches_fprquery,
                    total.kmers_processed,
                    t.kmers_matches,
                    t.kmers_from_classified_seqs,
                    f"{kperc:.6f}",
                ]
                f.write("\t".join(str(c) for c in cols) + "\n")

            for label in levels:
                row(hierarchy_totals[label][p], label)
            if len(levels) > 1:
                row(total, "-total-")


def _print_stats(totals, elapsed: float = 0.0):
    for p, t in totals.items():
        sp = float(t.seqs_processed) if t.seqs_processed else 1.0
        print(
            f"{'[' + p + '] ' if p else ''}{t.seqs_classified} sequences "
            f"classified ({t.seqs_classified / sp * 100:.2f}%), "
            f"{t.seqs_unique} unique, {t.matches} matches",
            file=sys.stderr,
        )
    if elapsed > 0:
        bp = sum(t.length_processed for t in totals.values())
        seqs = sum(t.seqs_processed for t in totals.values())
        # reference prints the same Mbp/m figure (GanonClassify.cpp:1091)
        print(
            f"ganon-tpu-torch classify processed {seqs} sequences "
            f"({bp / 1e6:.2f} Mbp) in {elapsed:.3f}s "
            f"({bp / 1e6 / (elapsed / 60):.1f} Mbp/m, "
            f"{seqs / elapsed:,.0f} reads/s)",
            file=sys.stderr,
        )
