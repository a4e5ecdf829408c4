"""Taxonomy trees: custom (.tax), NCBI taxdump, GTDB, and dummy.

A copy of ``ganon_tpu.taxonomy`` (which imports neither jax nor
pandas), so the port depends on nothing of the JAX package.
Self-contained replacement for the ``multitax`` dependency the reference
uses (CustomTx/NcbiTx/GtdbTx/DummyTx — report.py:10,21-72). API mirrors
the subset the pipeline needs: lineage (full, rank-projected, or rooted),
leaves, closest_parent, filter, latest (with NCBI merged ids), plus
genome-size estimation helpers (tax_util.py:143-224).
"""

from __future__ import annotations

import gzip
import os
import tarfile


class Taxonomy:
    undefined_node = ""
    undefined_rank = "na"
    undefined_name = "na"

    def __init__(self, root_node="1", root_name="root", root_rank="root",
                 sources=None):
        self.root_node = root_node
        self.root_name = root_name
        self.root_rank = root_rank
        self.sources = sources or []
        self._parent: dict[str, str] = {root_node: "0"}
        self._rank: dict[str, str] = {root_node: root_rank}
        self._name: dict[str, str] = {root_node: root_name}
        self._merged: dict[str, str] = {}
        self._children: dict[str, list[str]] | None = None
        self._lineages: dict[str, list[str]] | None = None

    # --- construction ------------------------------------------------------

    def add(self, node, parent=None, name=None, rank=None):
        if node == self.root_node:
            return
        self._parent[node] = parent if parent is not None else self.root_node
        self._rank[node] = rank if rank is not None else self.undefined_rank
        self._name[node] = name if name is not None else node
        self._children = None
        self._lineages = None

    # --- basic queries -----------------------------------------------------

    def __contains__(self, node):
        return node in self._parent

    def latest(self, node):
        """Current id for a node ('' if unknown; follows NCBI merged ids)."""
        if node in self._parent:
            return node
        if node in self._merged and self._merged[node] in self._parent:
            return self._merged[node]
        return self.undefined_node

    def parent(self, node):
        return self._parent.get(node, self.undefined_node)

    def rank(self, node):
        return self._rank.get(node, self.undefined_rank)

    def name(self, node):
        return self._name.get(node, self.undefined_name)

    def nodes(self):
        return list(self._parent.keys())

    def children(self, node):
        if self._children is None:
            self._children = {}
            for n, p in self._parent.items():
                if n != self.root_node:
                    self._children.setdefault(p, []).append(n)
        return self._children.get(node, [])

    # --- lineages ----------------------------------------------------------

    def build_lineages(self):
        self._lineages = {}
        for node in self._parent:
            self._lineages[node] = self._walk(node)

    def _walk(self, node):
        path = []
        cur = node
        seen = set()
        while cur in self._parent and cur not in seen:
            path.append(cur)
            seen.add(cur)
            if cur == self.root_node:
                break
            cur = self._parent[cur]
        path.reverse()
        # unrooted chains (inconsistent tax) yield a partial path
        return path

    def lineage(self, node, root_node=None, ranks=None):
        """Path root->node; with ``ranks``, one slot per rank ('' if absent)."""
        node = self.latest(node)
        if not node:
            return [] if not ranks else [self.undefined_node] * len(ranks)
        if self._lineages is not None and root_node is None and ranks is None:
            return list(self._lineages.get(node, []))
        full = (
            list(self._lineages[node])
            if self._lineages is not None and node in self._lineages
            else self._walk(node)
        )
        if root_node is not None:
            if root_node in full:
                full = full[full.index(root_node):]
            else:
                return []
        if ranks is None:
            return full
        out = [self.undefined_node] * len(ranks)
        for t in full:
            r = self.rank(t)
            if r in ranks:
                out[ranks.index(r)] = t
        return out

    def name_lineage(self, node, ranks=None):
        return [
            self.name(t) if t else self.undefined_node
            for t in self.lineage(node, ranks=ranks)
        ]

    def rank_lineage(self, node):
        return [self.rank(t) for t in self.lineage(node)]

    def leaves(self, node=None):
        """Leaf descendants of ``node`` (all leaves if None)."""
        self.children(self.root_node)  # build children map
        if node is None:
            node = self.root_node
        if node not in self._parent:
            return []
        out = []
        stack = [node]
        while stack:
            cur = stack.pop()
            ch = self._children.get(cur, [])
            if not ch:
                out.append(cur)
            else:
                stack.extend(ch)
        return out

    def closest_parent(self, node, ranks):
        """Nearest ancestor (incl. self) whose rank is in ``ranks``."""
        for t in reversed(self.lineage(node)):
            if self.rank(t) in ranks:
                return t
        return self.root_node

    def parent_rank(self, node, rank):
        """Ancestor at the given rank ('' if none)."""
        for t in self.lineage(node):
            if self.rank(t) == rank:
                return t
        return self.undefined_node

    def ranks(self):
        return set(self._rank.values())

    def write(self, path):
        """node/parent/rank/name TSV (root included)."""
        with open(path, "w") as f:
            for node in self._parent:
                f.write(
                    f"{node}\t{self._parent[node]}\t{self._rank[node]}\t"
                    f"{self._name[node]}\n"
                )

    # --- mutation ----------------------------------------------------------

    def filter(self, keep_nodes):
        """Prune to the given nodes plus their ancestors."""
        keep = {self.root_node}
        for node in keep_nodes:
            node = self.latest(node)
            if node:
                keep.update(self._walk(node))
        self._parent = {n: p for n, p in self._parent.items() if n in keep}
        self._rank = {n: r for n, r in self._rank.items() if n in keep}
        self._name = {n: v for n, v in self._name.items() if n in keep}
        self._children = None
        self._lineages = None

    def lca(self, nodes):
        """Lowest common ancestor of a list of nodes.

        Reference: multitax ``build_lca``/``lca`` used by taxonomy
        conversion (build_update.py:936-942) — deepest shared entry of
        the root-anchored lineages; root when the nodes share nothing.
        """
        lineages = []
        for n in nodes:
            n = self.latest(n)
            if n:
                lineages.append(self._walk(n))
        if not lineages:
            return self.undefined_node
        common = lineages[0]
        for lin in lineages[1:]:
            i = 0
            stop = min(len(common), len(lin))
            while i < stop and common[i] == lin[i]:
                i += 1
            common = common[:i]
            if not common:
                return self.root_node
        return common[-1] if common else self.root_node

    def check_consistency(self):
        for node in self._parent:
            if node == self.root_node:
                continue
            path = self._walk(node)
            if not path or path[0] != self.root_node:
                raise ValueError(f"node [{node}] not connected to root")
        return True


# --- constructors -----------------------------------------------------------


def load_tax_files(files, **kwargs):
    """CustomTx equivalent: node/parent/rank/name TSVs (first file wins)."""
    tax = Taxonomy(sources=list(files), **kwargs)
    for f in files:
        with _open_text(f) as fh:
            for line in fh:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 4:
                    continue
                node, parent, rank, name = fields[:4]
                if node == tax.root_node or node in tax:
                    continue
                tax.add(node, parent, name, rank)
    return tax


def load_ncbi(files=None, folder=None, **kwargs):
    """NcbiTx equivalent: nodes.dmp/names.dmp[/merged.dmp] or taxdump.tar.gz.

    A new_taxdump archive shipping only lineage files (taxidlineage.dmp +
    rankedlineage.dmp, which is all genome_updater mirrors) still yields a
    usable taxonomy: parents come from consecutive lineage pairs, names
    from rankedlineage; ranks are left undefined.
    """
    tax = Taxonomy(sources=list(files or [folder]), **kwargs)

    def handles():
        if files and len(files) == 1 and files[0].endswith((".tar.gz", ".tgz")):
            tar = tarfile.open(files[0], "r:gz")
            members = tar.getnames()
            if "nodes.dmp" not in members and "taxidlineage.dmp" in members:
                yield "taxidlineage", _tar_text(tar, "taxidlineage.dmp")
                if "rankedlineage.dmp" in members:
                    yield "rankedlineage", _tar_text(tar, "rankedlineage.dmp")
                return
            yield "nodes", _tar_text(tar, "nodes.dmp")
            yield "names", _tar_text(tar, "names.dmp")
            try:
                yield "merged", _tar_text(tar, "merged.dmp")
            except KeyError:
                pass
        else:
            src = files if files else [
                os.path.join(folder, n)
                for n in ("nodes.dmp", "names.dmp", "merged.dmp")
            ]
            names = ["nodes", "names", "merged"]
            for kind, path in zip(names, src):
                if os.path.exists(path):
                    yield kind, open(path)

    for kind, fh in handles():
        with fh:
            for line in fh:
                fields = [f.strip() for f in line.split("|")]
                if kind == "nodes":
                    node, parent, rank = fields[0], fields[1], fields[2]
                    if node != tax.root_node:
                        tax._parent[node] = parent
                        tax._rank[node] = rank
                elif kind == "names":
                    if len(fields) > 3 and fields[3] == "scientific name":
                        tax._name[fields[0]] = fields[1]
                elif kind == "merged":
                    tax._merged[fields[0]] = fields[1]
                elif kind == "taxidlineage":
                    node, lineage = fields[0], fields[1].split()
                    chain = lineage + [node]
                    for parent, child in zip(chain, chain[1:]):
                        if child != tax.root_node:
                            tax._parent.setdefault(child, parent)
                    if lineage and chain[0] != tax.root_node:
                        tax._parent.setdefault(chain[0], tax.root_node)
                elif kind == "rankedlineage":
                    tax._name.setdefault(fields[0], fields[1])
    tax._children = None
    tax._lineages = None
    return tax


GTDB_RANKS = {
    "d": "domain",
    "p": "phylum",
    "c": "class",
    "o": "order",
    "f": "family",
    "g": "genus",
    "s": "species",
}


def load_gtdb(files, **kwargs):
    """GtdbTx equivalent: taxonomy.tsv[.gz] accession -> 'd__..;p__..;..'."""
    tax = Taxonomy(sources=list(files), **kwargs)
    for f in files:
        with _open_text(f) as fh:
            for line in fh:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 2:
                    continue
                lineage = fields[1].split(";")
                parent = tax.root_node
                for entry in lineage:
                    entry = entry.strip()
                    if len(entry) < 3 or entry[1:3] != "__":
                        continue
                    rank = GTDB_RANKS.get(entry[0], tax.undefined_rank)
                    if entry not in tax:
                        tax.add(entry, parent, entry[3:], rank)
                    parent = entry
    return tax


def dummy_tax(**kwargs):
    """DummyTx equivalent: root-only taxonomy."""
    return Taxonomy(sources=["dummy"], **kwargs)


def _open_text(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _tar_text(tar, name):
    import io

    member = tar.extractfile(name)
    if member is None:
        raise KeyError(name)
    return io.TextIOWrapper(member)


# --- cross-taxonomy conversion ----------------------------------------------
#
# GTDB "conversion" files (multitax data/gtdb, one per GTDB version) hold one
# row per assembly:
#   {short acc} <tab> {t|f rep flag} <tab> {d__..;p__..;..;s__..} <tab> {ncbi taxid}
# They anchor the three conversion directions the reference supports
# (build_update.py:894-942): gtdb->gtdb (match accessions across two
# versions), gtdb->ncbi (lineage node -> ncbi taxids of its assemblies) and
# ncbi->gtdb (taxid -> gtdb species of its assemblies). One-to-many results
# are folded with :meth:`Taxonomy.lca` on the target taxonomy by the caller.


def parse_gtdb_conversion_file(path):
    """{acc: (gtdb lineage list, ncbi taxid)} from a conversion file."""
    rows = {}
    with _open_text(path) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 4:
                continue
            lineage = [e.strip() for e in fields[2].split(";")]
            rows[fields[0]] = (lineage, fields[3])
    return rows


def gtdb_conversion_map(source_file, target_file):
    """{source gtdb node: set(target gtdb nodes at the same rank)}.

    Assemblies present in both versions vote with their target-version
    lineage entry at the source node's rank position; assemblies dropped
    from the target version contribute nothing (a node whose assemblies
    all vanished converts to the empty set -> skipped by the caller).
    """
    src = parse_gtdb_conversion_file(source_file)
    tgt = parse_gtdb_conversion_file(target_file)
    conv: dict[str, set] = {}
    for acc, (lin_s, _) in src.items():
        t = tgt.get(acc)
        if t is None:
            continue
        lin_t = t[0]
        for i, node in enumerate(lin_s):
            if i < len(lin_t):
                conv.setdefault(node, set()).add(lin_t[i])
    return conv


def gtdb_to_ncbi_map(conversion_file):
    """{gtdb node (any rank): set(ncbi taxids of its assemblies)}."""
    m: dict[str, set] = {}
    for _acc, (lineage, taxid) in parse_gtdb_conversion_file(
        conversion_file
    ).items():
        for node in lineage:
            m.setdefault(node, set()).add(taxid)
    return m


def ncbi_to_gtdb_map(conversion_file):
    """{ncbi taxid: set(gtdb species of assemblies with that taxid)}."""
    m: dict[str, set] = {}
    for _acc, (lineage, taxid) in parse_gtdb_conversion_file(
        conversion_file
    ).items():
        if lineage:
            m.setdefault(taxid, set()).add(lineage[-1])
    return m


# --- genome sizes -----------------------------------------------------------


def parse_genome_size_tax(tax_files):
    """{node: genome_size} from .tax column 5 (largest wins).

    Reference: tax_util.parse_genome_size_tax:143-158.
    """
    genome_sizes = {}
    for f in tax_files:
        with open(f) as fh:
            for line in fh:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 5:
                    raise ValueError(f"no genome_size column in {f}")
                node, gsize = fields[0], int(fields[4])
                if node in genome_sizes and genome_sizes[node] > gsize:
                    continue
                genome_sizes[node] = gsize
    return genome_sizes


def estimate_genome_sizes(nodes, tax, leaves_sizes):
    """Average leaf sizes up the lineage of each used node.

    Reference: tax_util.get_genome_size:161-224 (offline part: the caller
    supplies ``leaves_sizes`` parsed from NCBI species_genome_size.txt.gz
    or GTDB metadata).
    """
    if not leaves_sizes:
        return {t: 1 for node in nodes for t in tax.lineage(node)} or {
            tax.root_node: 1
        }
    expanded = {}
    for t, size in leaves_sizes.items():
        if tax.latest(t):
            for leaf in tax.leaves(tax.latest(t)):
                expanded[leaf] = size
    genome_sizes = {}
    for node in nodes:
        for t in tax.lineage(node):
            if t in genome_sizes:
                continue
            vals = [expanded[leaf] for leaf in tax.leaves(t) if leaf in expanded]
            genome_sizes[t] = int(sum(vals) / len(vals)) if vals else 0
    if sum(genome_sizes.values()) == 0:
        genome_sizes[tax.root_node] = (
            int(sum(leaves_sizes.values()) / len(leaves_sizes))
            if leaves_sizes
            else 1
        )
    for node in nodes:
        if genome_sizes.get(node, 0) == 0:
            for t in tax.lineage(node):
                if genome_sizes.get(t, 0) == 0:
                    genome_sizes[t] = genome_sizes.get(
                        tax.parent(t), genome_sizes.get(tax.root_node, 1)
                    )
    return genome_sizes


def parse_genome_size_files(files, taxonomy: str):
    """Parse NCBI species_genome_size / GTDB metadata files -> leaf sizes."""
    leaves_sizes = {}
    if taxonomy.startswith("ncbi"):
        for file in files:
            with gzip.open(file, "rt") as f:
                next(f)
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    leaves_sizes[fields[0]] = int(fields[3])
    elif taxonomy.startswith("gtdb"):
        acc = {}
        for file in files:
            with gzip.open(file, "rt") as f:
                next(f)
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    t = fields[19].split(";")[-1]
                    acc.setdefault(t, []).append(int(fields[16]))
        leaves_sizes = {t: int(sum(v) / len(v)) for t, v in acc.items()}
    return leaves_sizes
