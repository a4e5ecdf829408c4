"""What decides ``correct``: the program's outputs against the reference.

The reference builds the filter itself, from the generated genomes and
the configuration's settings (its sizing included), compares the
program's filter file with it word for word, and classifies against its
own filter. Every number compared has a limit of its own; a run is
correct when each is within it. ``control=True`` puts the reference, run
on its filter folded to half the memory (``ganon_ref.fold_words``: the
configured false-positive rate broken), in the program's place, and
judges it the same way.
"""

from __future__ import annotations

import os
import sys

import torch

from portbench.reference import ganon_ref as ref
from portbench.reference import pruned_ref

# each number's limit (PERF.md gives the readings they were set from)
LIMITS = {
    "filter_mismatch": 0,   # header entries, words and bytes of the filter
    "reads_wrong": 0,       # reads whose ordered matches differ
    "rep_wrong": 0,         # reassigned .rep rows and totals that differ
    "tre_wrong": 0,         # report rows that differ (see PCT_GAP)
    "build_mismatch": 0,    # built filter: header entries and words
    "tax_wrong": 0,         # built .tax rows that differ
    "runs_failed": 0,       # window runs that raised or returned false
}
# a report row's percentage is printed to 5 decimals, so a sound row lies
# within 5e-6 of the reference's; a row further off than this differs
PCT_GAP = 3e-5


def sample_hashes(sample, k: int, w: int, device):
    """All reads' hashes in emission order with each one's read, and each
    read's hash count (mate 2's after mate 1's)."""
    parts, reads = [], []
    n = len(sample)
    for codes, lens in ((sample.codes1, sample.len1),
                        (sample.codes2, sample.len2)):
        order = torch.argsort(lens.cpu())
        budget = 1 << 24
        i = 0
        while i < n:
            L = int(lens[order[i]])
            j = min(n, i + max(1, budget // max(L, 1)))
            L = int(lens[order[j - 1]])
            idx = order[i:j].to(codes.device)
            c = codes[idx][:, :max(L, 1)].to(device)
            v, r = ref.read_hashes(c, lens[idx].to(device), k, w)
            parts.append(v)
            reads.append(idx.to(device)[r])
            i = j
    h = torch.cat(parts)
    rd = torch.cat(reads)
    order = torch.argsort(rd, stable=True)
    h, rd = h[order], rd[order]
    nh = torch.bincount(rd, minlength=n).to(torch.int32)
    return h, rd, nh


def reference_outputs(tables, layout, sample, flags, tax_rows, device,
                      fold=False) -> dict:
    h, rd, nh = sample_hashes(sample, layout.k, layout.w, device)
    if isinstance(layout, pruned_ref.PrunedLayout):
        r, t, v = pruned_ref.pruned_matches(
            *tables, layout, h, rd, nh, len(sample), fold=fold, **flags)
    else:
        counts = ref.flat_counts(ref.fold_words(tables) if fold else tables,
                                 layout, h, rd, len(sample), fold=fold)
        r, t, v = ref.select_matches(counts, nh, layout.fpr, **flags)
        del counts
    ids = sample.ids
    all_rows: dict = {}
    for a, b, c in zip(r.tolist(), t.tolist(), v.tolist()):
        all_rows.setdefault(ids[a], []).append((layout.targets[b], c))
    reassigned = ref.em_reassign(r, t, len(layout.targets))
    rep = ref.rep_rows(r, t, reassigned, layout.targets, tax_rows)
    classified = len(all_rows)
    unclassified = len(sample) - classified
    tre = ref.abundance_report(rep, classified, unclassified, tax_rows)
    return dict(all=all_rows, rep=rep, totals=(classified, unclassified),
                tre=tre)


def program_outputs(prefix: str) -> dict:
    all_rows: dict = {}
    with open(prefix + ".all") as f:
        for line in f:
            rid, tg, c = line.rstrip("\n").split("\t")
            all_rows.setdefault(rid, []).append((tg, int(c)))
    rep, totals = {}, [None, None]
    with open(prefix + ".rep") as f:
        for line in f:
            x = line.rstrip("\n").split("\t")
            if x[0] == "#total_classified":
                totals[0] = int(x[1])
            elif x[0] == "#total_unclassified":
                totals[1] = int(x[1])
            else:
                rep[x[1]] = (int(x[2]), int(x[3]), int(x[4]), x[5], x[6])
    tre = {}
    if os.path.exists(prefix + ".tre"):
        with open(prefix + ".tre") as f:
            for line in f:
                x = line.rstrip("\n").split("\t")
                tre[x[1]] = (x[0], x[2], x[3], int(x[4]), int(x[5]),
                             int(x[6]), int(x[7]), float(x[8]))
    return dict(all=all_rows, rep=rep, totals=tuple(totals), tre=tre)


def compare_outputs(got: dict, want: dict) -> dict:
    keys = set(got["all"]) | set(want["all"])
    reads_wrong = sum(got["all"].get(k) != want["all"].get(k) for k in keys)
    keys = set(got["rep"]) | set(want["rep"])
    rep_wrong = sum(got["rep"].get(k) != want["rep"].get(k) for k in keys)
    rep_wrong += sum(a != b for a, b in zip(got["totals"], want["totals"]))
    keys = set(got["tre"]) | set(want["tre"])
    tre_wrong = 0
    for k in keys:
        a, b = got["tre"].get(k), want["tre"].get(k)
        tre_wrong += (a is None or b is None or a[:7] != b[:7]
                      or abs(a[7] - b[7]) > PCT_GAP)
    return dict(reads_wrong=reads_wrong, rep_wrong=rep_wrong,
                tre_wrong=tre_wrong)


def target_order(got: list, names: list, counts: dict,
                 by_count: bool) -> list:
    """The program's order of the targets where the layout allows it: each
    target once (and, ``by_count``, hash counts not increasing along it);
    else the reference's own (the given names, stably by count
    descending with ``by_count``), which the header check then fails."""
    ok = sorted(got) == sorted(names)
    if ok and by_count:
        c = [counts[n] for n in got]
        ok = all(a >= b for a, b in zip(c, c[1:]))
    if ok:
        return list(got)
    return sorted(names, key=lambda n: -counts[n]) if by_count \
        else list(names)


def reference_filter(cc, compare: bool = True):
    """The reference's filter for a classify cell's configuration, built
    from the generated genomes, and (``compare``) the program's filter
    file held to it: its header and every word or byte. Returns
    ``(tables, layout, mismatches)``."""
    f, g, device = cc.cfg["filter"], cc.genomes, cc.device
    hashes = {name: ref.distinct_hashes(g.target(t).to(device),
                                        f["kmer_size"], f["window_size"])
              for t, name in enumerate(g.names)}
    counts = {n: int(h.numel()) for n, h in hashes.items()}
    if cc.filter_path.endswith(".hibf"):
        header, fine, coarse = pruned_ref.read_pruned(cc.filter_path)
        order = target_order(header["targets"], g.names, counts, True)
        layout = pruned_ref.PrunedLayout(order, [counts[n] for n in order],
                                         f)
        tables = pruned_ref.build_tables([hashes[n] for n in order], layout,
                                         device)
        del hashes
        parts = {}
        if compare:
            parts = layout.header_mismatch(header)
            parts["fine"] = pruned_ref.bytes_mismatch(fine, tables[0])
            parts["coarse"] = pruned_ref.bytes_mismatch(coarse, tables[1])
    else:
        header, bits = ref.read_filter(cc.filter_path)
        order = target_order(header["targets"], g.names, counts, False)
        layout = ref.Layout.from_config(order, [counts[n] for n in order], f)
        words = ref.build_matrix([hashes[n] for n in order], layout, device)
        del hashes
        parts = {}
        if compare:
            parts = layout.header_mismatch(header, bits.shape)
            parts["words"] = ref.words_mismatch(bits, words)
        tables = ref.as_i32(words)
        del words
    bad = sum(parts.values())
    if bad:
        print(f"filter check: { {k: v for k, v in parts.items() if v} }",
              file=sys.stderr)
    return tables, layout, bad


def judge_classify(cc, control: bool = False) -> dict:
    device = cc.device
    tables, layout, bad = reference_filter(cc, compare=not control)
    # the rooflines reckon their bytes on the reference's layout
    cc.ref_layout = layout
    cc.ref_coarse = tables[1] if isinstance(tables, tuple) else None
    out = {} if control else {"filter_mismatch": bad}
    j = cc.checked_run()
    k, prefix, _, ok = cc.runs[j]
    flags = {"rel_cutoff": 0.75, "rel_filter": 0.1, "fpr_query": 1e-5}
    flags.update({x: cc.mix["flags"][x] for x in flags
                  if x in cc.mix["flags"]})
    want = reference_outputs(tables, layout, cc.pool[k], flags, cc.tax_rows,
                             device)
    if control:
        got = reference_outputs(tables, layout, cc.pool[k], flags,
                                cc.tax_rows, device, fold=True)
    elif ok:
        got = program_outputs(prefix)
    else:
        got = dict(all={}, rep={}, totals=(None, None), tre={})
    del tables
    out.update(compare_outputs(got, want))
    out["runs_failed"] = sum(not r[3] for r in cc.runs)
    return out


def expected_tax_lines(bc) -> set:
    """The ``.tax`` a build of the subset writes: the used nodes of the
    taxdump and one row a target under its species (rank ``file``, the
    input target), every genome size 1 (``--skip-genome-size``)."""
    lines = set()
    for node, (parent, rank, name, _) in bc.tax_rows.items():
        if rank == "assembly":
            lines.add(f"{node}\t{parent}\tfile\t{name}\t1")
        else:
            rk = "root" if node == "1" else rank
            lines.add(f"{node}\t{'0' if node == '1' else parent}\t{rk}\t"
                      f"{name}\t1")
    return lines


def judge_build(bc, control: bool = False) -> dict:
    device = bc.device
    g = bc.genomes
    prefix, _, ok = bc.runs[bc.checked_run()]
    out = {"runs_failed": sum(not r[2] for r in bc.runs)}
    if not ok and not control:
        return dict(out, build_mismatch=-1, tax_wrong=-1)
    f = bc.cfg["filter"]
    names = [g.names[t] for t in bc.targets]
    hashes = [ref.distinct_hashes(g.target(t).to(device), f["kmer_size"],
                                  f["window_size"]) for t in bc.targets]
    layout = ref.Layout.from_config(names, [int(h.numel()) for h in hashes],
                                    f)
    want = ref.build_matrix(hashes, layout, device)
    del hashes
    if control:
        half = ref.fold_words(want)
        got = torch.zeros_like(want)
        got[:half.shape[0]] = half
        out["build_mismatch"] = int((got != want).sum())
        out["tax_wrong"] = 0
        return out
    header, bits = ref.read_filter(prefix + ".ibf")
    parts = layout.header_mismatch(header, bits.shape)
    parts["words"] = ref.words_mismatch(bits, want)
    if sum(parts.values()):
        print(f"build check: { {k: v for k, v in parts.items() if v} }",
              file=sys.stderr)
    out["build_mismatch"] = sum(parts.values())
    with open(prefix + ".tax") as fh:
        got_tax = {x.rstrip("\n") for x in fh if x.strip()}
    out["tax_wrong"] = len(got_tax ^ expected_tax_lines(bc))
    return out
