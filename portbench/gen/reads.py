"""Read samples drawn from the genomes, as a traffic mix's file states.

Paired reads: fragments of ``insert_mean`` +- ``insert_sd`` bases, mate 1
from the fragment's start and mate 2 reverse-complemented from its end,
half the fragments from the reverse strand. Each target gets its share
of the reads by a log-normal abundance (its quantiles, in an order drawn
from the seed); substitutions follow, and an exact share of pairs of
random bases (absent from the filter): every seed sends the same amount
of work, in another order. Each sample of a pool has its own seed; the
same seed gives the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.gen.genomes import Genomes, quantiles, seed_of

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Sample:
    """One sample of pairs: the mates' dna4 ranks (``codes1``/``codes2``
    ``[N, L]`` uint8) and lengths (``len1``/``len2``), the read ids, and
    the bases in all."""

    ids: list
    codes1: torch.Tensor
    len1: torch.Tensor
    codes2: torch.Tensor
    len2: torch.Tensor

    @property
    def bases(self) -> int:
        return int(self.len1.sum()) + int(self.len2.sum())

    def __len__(self) -> int:
        return len(self.ids)


def _abundance(mix, n_targets, rng):
    """Log-normal abundance over the targets: its quantiles, in an order
    drawn from the seed."""
    w = quantiles({"dist": "lognormal", "median": 1.0,
                   "sigma": float(mix["abundance_sigma"]), "min": 0,
                   "max": np.inf}, n_targets, integer=False)
    return rng.permutation(w / w.sum())


def _targets(p: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` reads' targets, each target taking its share of ``p`` (the
    largest remainders rounded up), in an order drawn from the seed."""
    c = np.floor(p * n).astype(np.int64)
    c[np.argsort(-(p * n - c), kind="stable")[:n - int(c.sum())]] += 1
    return rng.permutation(np.repeat(np.arange(len(p)), c))


def _share(n: int, share: float, rng) -> np.ndarray:
    """A mask of exactly ``round(n * share)`` reads drawn from the seed."""
    m = np.zeros(n, dtype=bool)
    m[rng.choice(n, size=int(round(n * share)), replace=False)] = True
    return m


def _mutate(codes: torch.Tensor, rate: float, gen) -> torch.Tensor:
    hit = torch.rand(codes.shape, generator=gen, device=codes.device) < rate
    shift = torch.randint(1, 4, codes.shape, generator=gen,
                          device=codes.device, dtype=torch.uint8)
    return torch.where(hit, (codes + shift) % 4, codes)


def make_sample(g: Genomes, mix: dict, seed: int, index: int, device,
                pairs: int | None = None) -> Sample:
    N = int(pairs or mix["pairs"])
    L = int(mix["read_len"])
    rng = np.random.default_rng(seed_of(seed, 10, index))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 11, index))
    tgt = _targets(_abundance(mix, len(g.names), rng), N, rng)
    lens = g.lengths[tgt]
    ins = np.clip(np.round(rng.normal(mix["insert_mean"], mix["insert_sd"],
                                      size=N)), L, None).astype(np.int64)
    ins = np.minimum(ins, lens)
    start = g.offsets[tgt] + (rng.random(N) * (lens - ins + 1)).astype(
        np.int64)
    pos = torch.arange(L, device=device)
    s1 = torch.from_numpy(start).to(device)
    s2 = torch.from_numpy(start + ins - L).to(device)
    left = g.codes[s1[:, None] + pos]
    right = 3 - g.codes[s2[:, None] + pos].flip(1)  # reverse complement
    flip = torch.from_numpy(rng.random(N) < 0.5).to(device)[:, None]
    m1 = torch.where(flip, right, left)
    m2 = torch.where(flip, left, right)
    rnd = torch.from_numpy(_share(N, mix["random_share"], rng)).to(
        device)[:, None]
    m1 = torch.where(rnd, torch.randint(0, 4, m1.shape, generator=gen,
                                        device=device, dtype=torch.uint8), m1)
    m2 = torch.where(rnd, torch.randint(0, 4, m2.shape, generator=gen,
                                        device=device, dtype=torch.uint8), m2)
    sub = float(mix["substitution"])
    m1, m2 = _mutate(m1, sub, gen), _mutate(m2, sub, gen)
    full = torch.full((N,), L, dtype=torch.int64, device=device)
    return Sample([f"r{i:07d}" for i in range(N)], m1.contiguous(), full,
                  m2.contiguous(), full.clone())


def _fastq(ids: list, codes: torch.Tensor) -> bytes:
    """Fixed-width FASTQ records, built in one array."""
    c = codes.cpu().numpy()
    N, L = c.shape
    head = np.frombuffer("".join(f"@{i}\n" for i in ids).encode(),
                         dtype=np.uint8).reshape(N, -1)
    rec = np.concatenate([
        head, _ASCII[c], np.full((N, 3), [10, 43, 10], dtype=np.uint8),
        np.full((N, L), 73, dtype=np.uint8),
        np.full((N, 1), 10, dtype=np.uint8)], axis=1)
    return rec.tobytes()


def write_fastq(sample: Sample, prefix: str) -> list:
    """The sample's FASTQ files, ``prefix``.1.fq and .2.fq."""
    paths = [prefix + ".1.fq", prefix + ".2.fq"]
    for p, codes in zip(paths, (sample.codes1, sample.codes2)):
        with open(p, "wb") as f:
            f.write(_fastq(sample.ids, codes))
    return paths


def write_fasta(path: str, name: str, codes: torch.Tensor,
                width: int = 80) -> None:
    """A one-sequence multi-line FASTA."""
    c = _ASCII[codes.cpu().numpy()]
    pad = -len(c) % width
    body = np.concatenate([c, np.zeros(pad, np.uint8)]).reshape(-1, width)
    body = np.concatenate([body, np.full((len(body), 1), 10, np.uint8)],
                          axis=1).reshape(-1)
    if pad:
        body = np.concatenate([body[:-(pad + 1)], [10]]).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(body.tobytes())
