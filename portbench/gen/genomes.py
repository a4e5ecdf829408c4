"""Reference genomes and their taxonomy, made from the seed.

A configuration's ``genomes`` block gives species, variants a species,
the variants' substitution rate, the species' length distribution and the
genera. The lengths are the distribution's quantiles in an order drawn
from the seed, so every seed builds the same amount of sequence. Each species' bases and its variants' substitutions are drawn on
``device`` by a ``torch.Generator`` seeded for that species; the lengths
and the genus of each species by numpy from the same seed.
Targets are the variants, named ``T<index>``; their genome sizes, averaged
up the lineage, go into the ``.tax`` rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

ROOT = "1"


def seed_of(seed: int, *parts: int) -> int:
    """A 63-bit seed for one stream drawn from the run's seed."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), *parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Genomes:
    codes: torch.Tensor        # uint8 dna4 ranks of every target, concatenated
    offsets: np.ndarray        # int64 [T + 1]
    names: list                # target names
    species_of: np.ndarray     # int64 [T]
    genus_of: np.ndarray       # int64 [S]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def target(self, t: int) -> torch.Tensor:
        return self.codes[int(self.offsets[t]):int(self.offsets[t + 1])]

    def species_taxid(self, s: int) -> str:
        return str(100000 + int(s))

    def genus_taxid(self, g: int) -> str:
        return str(1000 + int(g))

    def tax_rows(self, targets=None) -> dict:
        """``{node: (parent, rank, name, genome size)}`` of the root, the
        genera and species the targets fall in, and the targets (rank
        ``assembly``); a node's size is its leaves' mean, truncated."""
        ts = range(len(self.names)) if targets is None else targets
        lens = self.lengths
        sp_l: dict = {}
        for t in ts:
            sp_l.setdefault(int(self.species_of[t]), []).append(int(lens[t]))
        ge_l: dict = {}
        for s, ls in sp_l.items():
            ge_l.setdefault(int(self.genus_of[s]), []).extend(ls)
        all_l = [x for ls in sp_l.values() for x in ls]
        rows = {ROOT: (ROOT, "no rank", "root", int(sum(all_l) / len(all_l)))}
        for g in sorted(ge_l):
            rows[self.genus_taxid(g)] = (ROOT, "genus", f"genus{g}",
                                         int(sum(ge_l[g]) / len(ge_l[g])))
        for s in sorted(sp_l):
            rows[self.species_taxid(s)] = (
                self.genus_taxid(self.genus_of[s]), "species", f"species{s}",
                int(sum(sp_l[s]) / len(sp_l[s])))
        for t in ts:
            rows[self.names[t]] = (self.species_taxid(self.species_of[t]),
                                   "assembly", self.names[t], int(lens[t]))
        return rows


def quantiles(d: dict, n: int, integer: bool = True) -> np.ndarray:
    """The ``n`` midpoint quantiles of a length distribution (``uniform``
    over ``min``-``max``, or ``lognormal`` by ``median`` and ``sigma``),
    clipped to ``min``-``max``: every seed gets the same set of sizes."""
    q = (np.arange(n) + 0.5) / n
    if d["dist"] == "uniform":
        x = d["min"] + q * (d["max"] - d["min"])
    elif d["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(v) for v in q])
        x = d["median"] * np.exp(d["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {d['dist']}")
    x = np.clip(x, d["min"], d["max"])
    return np.round(x).astype(np.int64) if integer else x


def species_lengths(spec: dict, n: int, rng: np.random.Generator):
    """The species' lengths: the distribution's quantiles in an order
    drawn from the seed."""
    return rng.permutation(quantiles(spec["length"], n))


def make_genomes(spec: dict, seed: int, device,
                 species: int | None = None) -> Genomes:
    """The configuration's genomes, or those of its first ``species``
    species (each species' bases come from a stream of its own, so a
    subset holds the same bases as the whole)."""
    S_all = int(spec["species"])
    S = min(int(species or S_all), S_all)
    V = int(spec["variants"])
    rng = np.random.default_rng(seed_of(seed, 1))
    slen = species_lengths(spec, S_all, rng)[:S]
    genus_of = rng.integers(0, int(spec["genera"]), size=S_all)[:S]
    gen = torch.Generator(device=device)
    offsets = np.zeros(S * V + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.repeat(slen, V))
    codes = torch.empty((int(offsets[-1]),), dtype=torch.uint8,
                        device=device)
    rate = float(spec["divergence"])
    for s in range(S):
        gen.manual_seed(seed_of(seed, 2, s))
        n = int(slen[s])
        b = torch.randint(0, 4, (n,), generator=gen, device=device,
                          dtype=torch.uint8)
        for v in range(V):
            t = s * V + v
            hit = torch.rand((n,), generator=gen, device=device) < rate
            shift = torch.randint(1, 4, (n,), generator=gen, device=device,
                                  dtype=torch.uint8)
            codes[offsets[t]:offsets[t + 1]] = torch.where(
                hit, (b + shift) % 4, b)
    return Genomes(codes=codes, offsets=offsets,
                   names=[f"T{t:05d}" for t in range(S * V)],
                   species_of=np.repeat(np.arange(S), V), genus_of=genus_of)


def write_tax(path: str, rows: dict) -> None:
    """A ``.tax`` file: node, parent, rank, name, genome size."""
    with open(path, "w") as f:
        for node, (parent, rank, name, size) in rows.items():
            f.write(f"{node}\t{'0' if node == ROOT else parent}\t{rank}\t"
                    f"{name}\t{size}\n")


def write_taxdump(folder: str, rows: dict):
    """NCBI ``nodes.dmp`` and ``names.dmp`` of the non-target nodes;
    returns their paths."""
    nodes, names = (os.path.join(folder, n) for n in ("nodes.dmp",
                                                        "names.dmp"))
    with open(nodes, "w") as f, open(names, "w") as g:
        for node, (parent, rank, name, _) in rows.items():
            if rank == "assembly":
                continue
            f.write(f"{node}\t|\t{parent}\t|\t{rank}\t|\n")
            g.write(f"{node}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    return nodes, names
