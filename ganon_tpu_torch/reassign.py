"""EM reassignment of multi-matching reads.

Port of ``ganon_tpu.reassign`` without pandas: the same numpy EM over
flat match arrays (``_winners``, ``_em`` and the writers are copies);
only ``_load_all`` reads the ``.all`` file through the ``csv`` module,
coding reads and targets by first occurrence with dicts where the JAX
package calls ``pandas.factorize``. The equivalent of the reference EM
reassigner (``pirovc/ganon:src/ganon/reassign.py``): seeds per-target
probabilities with unique-match counts, iteratively reassigns every
multi-match read to its highest-probability target (ties -> first
match), rewrites ``.one`` (unique passthrough + winners) and ``.rep``
(lca column becomes reassigned - unique). The ``.rep`` reassigned counts
come from the winners of the LAST EM iteration (pre-update
probabilities), while ``.one`` winners are recomputed with the final
post-update probabilities; all-zero probabilities fall back to each
read's first match.
"""

from __future__ import annotations

import csv
import os
import pathlib
from dataclasses import dataclass, field

import numpy as np

from ganon_tpu_torch.util import find_rep_files


@dataclass
class ReassignConfig:
    input_prefix: list = field(default_factory=list)
    output_prefix: str = ""
    max_iter: int = 10
    threshold: float = 0.0
    remove_all: bool = False
    skip_one: bool = False
    skip_rep: bool = False
    quiet: bool = True
    verbose: bool = False


def _load_all(af: str):
    """Parse one ``.all`` file into flat arrays.

    Returns (read_names, target_names, r_s, t_s, k_s, seg_starts,
    seg_len) where the match arrays are stably sorted by read id code —
    one contiguous segment per read, matches in file order within a
    segment, reads/targets coded in first-occurrence order (matching the
    reference's insertion-order dicts). Tab-separated, no quoting, no NA
    parsing, blank lines skipped, as ``ganon_tpu.reassign`` reads it.
    """
    rcode: dict[str, int] = {}
    tcode: dict[str, int] = {}
    r, t, k = [], [], []
    with open(af, newline="") as f:
        for row in csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
            if not row:
                continue
            if len(row) < 3:
                raise ValueError(f"{af}: expected read, target and count "
                                 f"columns, got {row!r}")
            r.append(rcode.setdefault(row[0], len(rcode)))
            t.append(tcode.setdefault(row[1], len(tcode)))
            k.append(int(row[2]))
    if not r:
        e = np.empty(0, np.int64)
        return [], [], e, e, e, e, e
    rcodes = np.asarray(r, dtype=np.int64)
    order = np.argsort(rcodes, kind="stable")
    r_s = rcodes[order]
    t_s = np.asarray(t, dtype=np.int64)[order]
    k_s = np.asarray(k, dtype=np.int64)[order]
    seg_starts = np.flatnonzero(np.r_[True, r_s[1:] != r_s[:-1]])
    seg_len = np.diff(np.r_[seg_starts, len(r_s)])
    return list(rcode), list(tcode), r_s, t_s, k_s, seg_starts, seg_len


def _winners(prob, t_s, seg_starts, seg_of_match):
    """Per-read winning match position: first match whose target
    probability equals the segment max (all-zero segment -> first match,
    matching reference get_top_match's strict ``>`` against 0.0)."""
    n = len(t_s)
    pm = prob[t_s]
    segmax = np.maximum.reduceat(pm, seg_starts)
    cand = np.where(pm == segmax[seg_of_match], np.arange(n), n)
    return np.minimum.reduceat(cand, seg_starts)


def _em(t_s, seg_starts, seg_len, n_targets, max_iter, threshold):
    """Run the EM loop; returns (reassigned counts [T] from the last
    iteration's pre-update winners, final prob [T])."""
    n_matches = len(t_s)
    n_reads = len(seg_starts)
    multi = seg_len > 1
    unique_tid = t_s[seg_starts[~multi]]
    initial_weight = np.bincount(unique_tid, minlength=n_targets).astype(
        np.int64
    )
    total_initial = int(initial_weight.sum())
    prob = initial_weight / (total_initial if total_initial else 1)
    seg_of_match = np.repeat(np.arange(n_reads), seg_len)

    reassigned = initial_weight.copy()
    em_ite = 0
    while True:
        if n_matches:
            win_pos = _winners(prob, t_s, seg_starts, seg_of_match)
            reassigned = initial_weight + np.bincount(
                t_s[win_pos[multi]], minlength=n_targets
            )
        new_prob = (
            reassigned / n_reads
            if n_reads
            else np.zeros(n_targets)
        )
        diff = float(np.abs(prob - new_prob).sum())
        prob = new_prob
        if diff <= threshold:
            break
        if max_iter > 0 and em_ite == max_iter - 1:
            break
        em_ite += 1
    return reassigned, prob


def reassign(cfg: ReassignConfig) -> bool:
    rep_files = []
    for ip in cfg.input_prefix:
        rep_files.extend(find_rep_files(ip))
    if not rep_files:
        raise ValueError("no .rep files found for --input-prefix")

    for rep_file in rep_files:
        p = pathlib.Path(rep_file)
        rep_prefix = str(pathlib.Path(p.parent, p.stem))
        if cfg.output_prefix:
            out_prefix = (
                cfg.output_prefix
                if len(rep_files) == 1
                else cfg.output_prefix + str(p.stem)
            )
        else:
            out_prefix = rep_prefix
        rep_file_out = "" if cfg.skip_rep else out_prefix + ".rep"

        # discover per-hierarchy .all files
        all_files: dict[str, str] = {}
        rep_info = []
        with open(rep_file) as f:
            for line in f:
                if line[0] != "#":
                    all_files[line.split("\t")[0]] = ""
                else:
                    rep_info.append(line.rstrip("\n"))
        for h in list(all_files.keys()):
            if os.path.isfile(rep_prefix + "." + h + ".all"):
                all_files[h] = rep_prefix + "." + h + ".all"
            elif os.path.isfile(rep_prefix + ".all"):
                all_files = {"": rep_prefix + ".all"}
                break
            else:
                raise FileNotFoundError(
                    f"no matching .all files for {rep_prefix} [{h}]"
                )

        new_rep = []
        for hierarchy, af in all_files.items():
            (
                rnames, tnames, _r_s, t_s, k_s, seg_starts, seg_len,
            ) = _load_all(af)
            n_targets = len(tnames)
            n_reads = len(seg_starts)

            reassigned, prob = _em(
                t_s, seg_starts, seg_len, n_targets,
                cfg.max_iter, cfg.threshold,
            )

            if not cfg.skip_one:
                one_out = (
                    out_prefix + ".one"
                    if len(all_files) == 1
                    else out_prefix + "." + hierarchy + ".one"
                )
                with open(one_out, "w") as f:
                    if n_reads:
                        seg_of_match = np.repeat(
                            np.arange(n_reads), seg_len
                        )
                        win_pos = _winners(
                            prob, t_s, seg_starts, seg_of_match
                        )
                        win_t = t_s[win_pos]
                        win_k = k_s[win_pos]
                        f.writelines(
                            f"{rnames[r]}\t{tnames[win_t[r]]}\t{win_k[r]}\n"
                            for r in range(n_reads)
                        )

            if rep_file_out:
                tmap = {t: i for i, t in enumerate(tnames)}
                with open(rep_file) as f:
                    for line in f:
                        if line[0] == "#":
                            continue
                        fields = line.rstrip("\n").split("\t")
                        h_name, target = fields[0], fields[1]
                        direct = fields[2]
                        unique = int(fields[3])
                        rank = fields[5] if len(fields) >= 6 else ""
                        name = fields[6] if len(fields) >= 7 else ""
                        if (
                            hierarchy == "" or h_name == hierarchy
                        ) and target in tmap:
                            new_rep.append(
                                [
                                    h_name, target, direct, unique,
                                    int(reassigned[tmap[target]]) - unique,
                                    rank, name,
                                ]
                            )

        if rep_file_out:
            with open(rep_file_out, "w") as f:
                for row in new_rep:
                    f.write("\t".join(str(v) for v in row) + "\n")
                for info in rep_info:
                    f.write(info + "\n")

        if cfg.remove_all:
            for af in all_files.values():
                os.remove(af)
    return True
