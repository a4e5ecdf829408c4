"""A classify cell: the filter built and loaded in set-up, then whole
samples through ``ganon_tpu_torch.cli.main("classify", ...)`` back to back.

Set-up makes the configuration's genomes from the seed on the card,
extracts each target's minimizers and builds the filter with the
program's build path, saves it as the raw container with the ``.tax`` of
the generated taxonomy, loads it once (span ``load``: the classify calls
then find it in the program's filter cache, as ``--batch-reads`` keeps
one load for many samples), writes the traffic mix's pool of samples as
FASTQ and classifies the first one as the warm-up. The window classifies
pool samples in turn, each to its own output prefix, at the mix's flags.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import torch

from portbench.gen.genomes import make_genomes, seed_of, write_tax
from portbench.gen.reads import make_sample, write_fastq
from portbench.harness import host


class ClassifyCell:
    kind = "classify"

    def __init__(self, cell, seed: int, device: str, work: str, tracer,
                 scale: dict | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.work, self.tracer = work, tracer
        self.scale = scale or {}
        self.cfg = cell.config
        self.mix = cell.traffic
        self.runs: list = []      # (pool index, prefix, seconds, ok)
        self.host: list = []      # host.reading() at the window's start
        #                           and after each run
        # the reference's layout (and pruned coarse table), set by the check
        self.ref_layout = self.ref_coarse = None

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from ganon_tpu_torch.classify import device as dev
        from ganon_tpu_torch.index.builder import _HashExtractor

        f = self.cfg["filter"]
        self.genomes = g = make_genomes(self.cfg["genomes"], self.seed,
                                        self.device,
                                        species=self.scale.get("species"))
        codes = g.codes.cpu().numpy()
        ex = _HashExtractor(f["kmer_size"], f["window_size"],
                            device=self.device)
        for t, name in enumerate(g.names):
            ex.add_encoded(name, codes[g.offsets[t]:g.offsets[t + 1]])
        target_hashes = ex.finish()
        del codes
        self.db = os.path.join(self.work, "db")
        self.filter_path, self.filter_bytes = self._build(target_hashes, f)
        del target_hashes
        self.tax_rows = g.tax_rows()
        write_tax(self.db + ".tax", self.tax_rows)
        if self.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = dev.load_device_filter(self.filter_path, self.device)
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.load_s = time.perf_counter() - t0
        tbl = getattr(loaded, "tbl8", None)
        self.table_bytes = None if tbl is None else int(tbl.numel())
        del loaded
        self.pool, self.files = [], []
        for i in range(int(self.mix["pool"])):
            s = make_sample(g, self.mix, self.seed, i, self.device,
                            self.scale.get("sample"))
            self.pool.append(s)
            self.files.append(write_fastq(s, os.path.join(self.work,
                                                          f"pool{i}")))
        self.input_bytes = sum(os.path.getsize(p) for fs in self.files
                               for p in fs)
        self._classify(0, os.path.join(self.work, "warm"))

    def _build(self, target_hashes: dict, f: dict):
        """The filter the configuration states, at its settings, saved as
        the raw container: a flat IBF, or the merged-bin pruned forest
        that ``--filter-type hibf --hibf-layout auto`` builds at 2048
        targets or more. Returns (path, bytes of its tables)."""
        if f["type"] == "ibf":
            from ganon_tpu_torch.index.ibf import build_ibf

            ibf = build_ibf(target_hashes, kmer_size=f["kmer_size"],
                            window_size=f["window_size"],
                            max_fp=f["max_fp"], mode=f["mode"],
                            hash_functions=f["hash_functions"],
                            tpu_sizing=f["tpu_sizing"] == "auto",
                            device=self.device)
            ibf.save_raw(self.db + ".ibf")
            return self.db + ".ibf", int(ibf.bits.nbytes)
        from ganon_tpu_torch.index.pruned import build_pruned

        pf = build_pruned(target_hashes, kmer_size=f["kmer_size"],
                          window_size=f["window_size"], max_fp=f["max_fp"],
                          fine_h=f["fine_h"], coarse_fp=f["coarse_fp"],
                          coarse_h=f["coarse_h"], group_size=f["group_size"],
                          device=None if self.device == "cuda"
                          else self.device)
        pf.save_raw(self.db + ".hibf")
        return self.db + ".hibf", int(pf.fine.nbytes + pf.coarse.nbytes)

    # -- the window ------------------------------------------------------------

    def _classify(self, i: int, prefix: str) -> bool:
        from ganon_tpu_torch.cli import main

        return bool(main("classify", db_prefix=[self.db],
                         output_prefix=prefix, device=self.device,
                         paired_reads=list(self.files[i]),
                         **self.mix["flags"]))

    def window(self, seconds: float) -> tuple:
        """Samples back to back until ``seconds`` have passed; returns
        (window seconds, bases classified). Each sample's outputs are
        deleted after it, but for the run the check judges."""
        os.makedirs(os.path.join(self.work, "out"), exist_ok=True)
        checked = self.checked_run()
        bases = 0
        self.host.append(host.reading())
        t_start = self.host[0][0]
        while True:
            i = len(self.runs)
            k = i % len(self.pool)
            prefix = os.path.join(self.work, "out", f"s{i}")
            t0 = time.perf_counter()
            with self.tracer.span("sample"):
                try:
                    ok = self._classify(k, prefix)
                except Exception as e:  # a failed sample is counted, not fatal
                    print(f"sample {i} failed: {e!r}", flush=True,
                          file=sys.stderr)
                    ok = False
            if i != checked:
                for f in glob.glob(prefix + ".*"):
                    os.remove(f)
            self.host.append(host.reading())
            t1 = self.host[-1][0]
            self.runs.append((k, prefix, t1 - t0, ok))
            if ok:
                bases += self.pool[k].bases
            if t1 - t_start >= seconds and len(self.runs) > checked:
                return t1 - t_start, bases

    def output_bytes(self) -> int:
        """Bytes of the judged run's outputs (each window run writes as
        many, deleted after it but for this one)."""
        prefix = self.runs[self.checked_run()][1]
        return sum(os.path.getsize(f) for f in glob.glob(prefix + ".*"))

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        from ganon_tpu_torch.classify import device as dev

        dev._FILTER_CACHE.clear()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def checked_run(self) -> int:
        """The window run whose outputs are judged: one of the first eight
        (the window runs at least that many), drawn from the seed."""
        return seed_of(self.seed, 30) % 8

    # -- traced-run extras -----------------------------------------------------

    def instrument(self) -> None:
        import importlib

        from ganon_tpu_torch.classify import engine

        reassign = importlib.import_module("ganon_tpu_torch.reassign")
        report = importlib.import_module("ganon_tpu_torch.report.report")

        tr = self.tracer
        tr.wrap(engine, "run_classify", "classify", keep=True)
        tr.wrap(engine, "_dispatch_batch_fast", "dispatch")
        tr.wrap(engine, "_finish_batch_fast", "finish")
        tr.wrap(engine, "_classify_batch", "finish")
        tr.wrap(reassign, "reassign", "reassign")
        tr.wrap(report, "report", "report")
