"""A build cell: whole ``build-custom`` runs of a reference subset, back
to back, through ``ganon_tpu_torch.cli.main("build-custom", ...)``.

Set-up makes the subset's genomes from the seed (the configuration's
first targets; each species draws from a stream of its own, so they are
the same bases as in the whole configuration), writes one multi-line
FASTA a target, an ``--input-file`` table (file, target, species taxid)
and an NCBI taxdump of the generated taxonomy, then builds the subset's
first four targets as the warm-up. Each window build goes to a fresh
prefix, deleted after it but for the one the check judges.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

from portbench.gen.genomes import make_genomes, seed_of, write_taxdump
from portbench.gen.reads import write_fasta
from portbench.harness import host


class BuildCell:
    kind = "build"

    def __init__(self, cell, seed: int, device: str, work: str, tracer,
                 scale: dict | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.work, self.tracer = work, tracer
        self.scale = scale or {}
        self.cfg = cell.config
        self.mix = cell.traffic
        self.runs: list = []     # (prefix, seconds, ok)
        self.phases: list = []   # each window build's StopClock phases
        self.host: list = []     # host.reading() at the window's start
        #                          and after each build

    def setup(self) -> None:
        n = int(self.scale.get("targets") or self.mix["targets"])
        spec = self.cfg["genomes"]
        species = -(-n // int(spec["variants"]))
        self.genomes = g = make_genomes(spec, self.seed, self.device,
                                        species=species)
        self.targets = list(range(n))
        self.tax_rows = g.tax_rows(self.targets)
        inp = os.path.join(self.work, "input")
        os.makedirs(inp, exist_ok=True)
        rows = []
        for t in self.targets:
            p = os.path.join(inp, g.names[t] + ".fna")
            write_fasta(p, g.names[t] + " generated", g.target(t),
                        int(self.mix["line_width"]))
            rows.append(f"{p}\t{g.names[t]}\t"
                        f"{g.species_taxid(g.species_of[t])}")
        self.nodes, self.names = write_taxdump(inp, self.tax_rows)
        self.input_file = os.path.join(inp, "input.tsv")
        with open(self.input_file, "w") as f:
            f.write("\n".join(rows) + "\n")
        warm = os.path.join(inp, "warm.tsv")
        with open(warm, "w") as f:
            f.write("\n".join(rows[:4]) + "\n")
        self.bases = int(sum(g.lengths[t] for t in self.targets))
        self.input_bytes = sum(os.path.getsize(r.split("\t")[0])
                               for r in rows)
        self._build(warm, os.path.join(self.work, "warm", "db"))

    def _build(self, input_file: str, prefix: str) -> bool:
        from ganon_tpu_torch.cli import main

        f = self.cfg["filter"]
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        return bool(main("build-custom", input_file=input_file,
                         db_prefix=prefix, taxonomy="ncbi",
                         taxonomy_files=[self.nodes, self.names],
                         filter_type=f["type"], max_fp=f["max_fp"],
                         mode=f["mode"], kmer_size=f["kmer_size"],
                         window_size=f["window_size"], device=self.device,
                         **self.mix["flags"]))

    def checked_run(self) -> int:
        """The window build the check judges: one of the first two (every
        window holds two whole builds), drawn from the seed."""
        return seed_of(self.seed, 30) % min(2, len(self.runs))

    def window(self, seconds: float) -> tuple:
        keep = seed_of(self.seed, 30) % 2
        bases = 0
        self.host.append(host.reading())
        t_start = self.host[0][0]
        while True:
            i = len(self.runs)
            prefix = os.path.join(self.work, f"b{i}", "db")
            t0 = time.perf_counter()
            with self.tracer.span("build"):
                try:
                    ok = self._build(self.input_file, prefix)
                except Exception as e:  # a failed build is counted
                    print(f"build {i} failed: {e!r}", file=sys.stderr,
                          flush=True)
                    ok = False
            if i != keep:
                shutil.rmtree(os.path.dirname(prefix), ignore_errors=True)
            self.host.append(host.reading())
            t1 = self.host[-1][0]
            self.runs.append((prefix, t1 - t0, ok))
            if ok:
                bases += self.bases
            if t1 - t_start >= seconds and len(self.runs) >= 2:
                return t1 - t_start, bases

    def output_bytes(self) -> int:
        """Bytes of the judged build's files (each window build writes as
        many, deleted after it but for this one)."""
        top = os.path.dirname(self.runs[self.checked_run()][0])
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(top) for f in fs)

    def release(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def instrument(self) -> None:
        from ganon_tpu_torch.index import builder

        real = builder._finish_build
        phases = self.phases

        def finish(cfg, ibf, stats, ph=None, mark=None):
            out = real(cfg, ibf, stats, ph, mark)
            phases.append(dict(ph or []))
            return out

        self.tracer.replace(builder, "_finish_build", finish)
