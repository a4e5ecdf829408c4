"""A fake NCBI/GTDB repository tree and e-utils endpoint for offline tests.

The ``write_*`` functions lay out the part of
``https://ftp.ncbi.nlm.nih.gov`` and ``https://data.gtdb.ecogenomic.org``
that ``ganon build`` fetches, so that ``local_dir=root`` serves it: each
``genomes/{source}/{group}/assembly_summary.txt`` (and the source's own
``assembly_summary_{source}.txt``) in the 38-column layout, one
``{ftp_path}/{name}_genomic.fna.gz`` per assembly (with md5checksums.txt
when asked), the ``pub/taxonomy/new_taxdump/new_taxdump.tar.gz`` (nodes,
names, merged, taxidlineage), the species genome sizes and the GTDB
release files. ``serve_eutils(seqs)`` runs a local ``http.server``
answering esummary, efetch and elink as NCBI's endpoint does (the
request contract of ``tests/test_eutils.py``). Tests import it as
``ncbi_tree`` (pytest puts ``tests/`` on the path); ``chip_smoke.py``
loads it by its path.
"""

from __future__ import annotations

import gzip
import io
import os
import tarfile
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

NCBI = "https://ftp.ncbi.nlm.nih.gov"

# the 38 columns of today's assembly_summary files
SUMMARY_COLS = [
    "assembly_accession", "bioproject", "biosample", "wgs_master",
    "refseq_category", "taxid", "species_taxid", "organism_name",
    "infraspecific_name", "isolate", "version_status", "assembly_level",
    "release_type", "genome_rep", "seq_rel_date", "asm_name",
    "asm_submitter", "gbrs_paired_asm", "paired_asm_comp", "ftp_path",
    "excluded_from_refseq", "relation_to_type_material",
    "asm_not_live_date", "assembly_type", "group", "genome_size",
    "genome_size_ungapped", "gc_percent", "replicon_count",
    "scaffold_count", "contig_count", "annotation_provider",
    "annotation_name", "annotation_date", "total_gene_count",
    "protein_coding_gene_count", "non_coding_gene_count", "pubmed_id",
]


@dataclass
class Assembly:
    acc: str
    taxid: str
    species: str = ""
    source: str = "refseq"
    group: str = "bacteria"
    status: str = "latest"
    level: str = "Complete Genome"
    category: str = "na"
    date: str = "2020/01/01"
    organism: str = ""
    infra: str = ""
    seq: str = ""  # the genome; empty: a short constant one
    ftp_na: bool = False  # ftp_path "na"
    # column name -> value replacing the generated one (raw text: a "#"
    # or a quote stays as written)
    extra: dict = field(default_factory=dict)
    ragged: int = 0  # keep only the first ``ragged`` fields of the line

    @property
    def name(self):
        return f"{self.acc}_ASM{self.acc.split('_')[1].split('.')[0]}v1"

    @property
    def ftp_path(self):
        if self.ftp_na:
            return "na"
        num = self.acc.split("_")[1].split(".")[0].rjust(9, "0")
        return (f"{NCBI}/genomes/all/{self.acc[:3]}/{num[:3]}/{num[3:6]}/"
                f"{num[6:9]}/{self.name}")


def summary_line(a: Assembly) -> str:
    vals = {c: f"{c[:3]}{i}" for i, c in enumerate(SUMMARY_COLS)}
    vals.update(
        assembly_accession=a.acc, refseq_category=a.category, taxid=a.taxid,
        species_taxid=a.species or a.taxid,
        organism_name=a.organism or f"Organism {a.taxid}",
        infraspecific_name=a.infra, isolate="", version_status=a.status,
        assembly_level=a.level, seq_rel_date=a.date, ftp_path=a.ftp_path,
        group=a.group, wgs_master="", excluded_from_refseq="",
        asm_not_live_date="na",
    )
    vals.update(a.extra)
    fields = [vals[c] for c in SUMMARY_COLS]
    if a.ragged:
        fields = fields[:a.ragged]
    return "\t".join(fields) + "\n"


def _gz(path, text: str | bytes, level: int = 6):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = text.encode() if isinstance(text, str) else text
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(data)
    return path


def _text(path, text: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write(text)
    return path


def genome_text(a: Assembly) -> str:
    seq = a.seq or ("ACGT" * 40)
    return (f">{a.acc}_seq1 {a.organism or a.taxid}\n"
            + "\n".join(seq[i:i + 80] for i in range(0, len(seq), 80)) + "\n")


def local_path(root: str, url: str) -> str:
    return os.path.join(root, url[len(NCBI) + 1:])


def write_summaries(root: str, assemblies) -> None:
    """The assembly_summary files of every (source, group) the assemblies
    name, and each source's own file over all its groups."""
    head = ("#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_assembly_"
            "summary.txt for a description of the columns in this file.\n"
            "# " + "\t".join(SUMMARY_COLS) + "\n")
    by: dict = {}
    for a in assemblies:
        by.setdefault((a.source, a.group), []).append(a)
    for source in {s for s, _ in by}:
        lines = []
        for (s, g), rows in sorted(by.items()):
            if s != source:
                continue
            text = "".join(summary_line(a) for a in rows)
            _text(os.path.join(root, "genomes", s, g, "assembly_summary.txt"),
                  head + text)
            lines.append(text)
        _text(os.path.join(root, "genomes", source,
                           f"assembly_summary_{source}.txt"),
              head + "".join(lines))


def write_genomes(root: str, assemblies, md5: dict | None = None) -> None:
    """``{ftp_path}/{name}_genomic.fna.gz`` for each assembly with an
    ftp_path; ``md5`` (acc -> checksum, or "good") writes
    md5checksums.txt."""
    import hashlib

    for a in assemblies:
        if a.ftp_na:
            continue
        folder = local_path(root, a.ftp_path)
        p = _gz(os.path.join(folder, a.name + "_genomic.fna.gz"),
                genome_text(a), level=1)
        if md5 and a.acc in md5:
            with open(p, "rb") as f:
                good = hashlib.md5(f.read()).hexdigest()
            s = good if md5[a.acc] == "good" else md5[a.acc]
            _text(os.path.join(folder, "md5checksums.txt"),
                  f"{s}  ./{a.name}_genomic.fna.gz\n")


def write_taxdump(root: str, nodes, names=None, merged=None) -> str:
    """``new_taxdump.tar.gz`` of ``nodes`` [(taxid, parent, rank)]: nodes,
    names, merged and taxidlineage."""
    names = names or {}
    parent = {n: p for n, p, _ in nodes}

    def lineage(n):
        out = []
        while parent.get(n, n) != n:
            n = parent[n]
            out.append(n)
        return " ".join(reversed(out))

    files = {
        "nodes.dmp": "".join(f"{n}\t|\t{p}\t|\t{r}\t|\n" for n, p, r in nodes),
        "names.dmp": "".join(
            f"{n}\t|\t{names.get(n, 'name ' + n)}\t|\t\t|\tscientific name"
            "\t|\n" for n, _, _ in nodes),
        "merged.dmp": "".join(f"{a}\t|\t{b}\t|\n"
                              for a, b in (merged or {}).items()),
        "taxidlineage.dmp": "".join(f"{n}\t|\t{lineage(n)} \t|\n"
                                    for n, _, _ in nodes),
    }
    path = os.path.join(root, "pub", "taxonomy", "new_taxdump",
                        "new_taxdump.tar.gz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w:gz") as tar:
        for name, text in files.items():
            b = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(b)
            tar.addfile(ti, io.BytesIO(b))
    return path


def write_genome_sizes(root: str, sizes: dict) -> str:
    return _gz(os.path.join(root, "genomes", "ASSEMBLY_REPORTS",
                            "species_genome_size.txt.gz"),
               "#species_taxid\tname\trank\texpected_ungapped_length\n"
               + "".join(f"{t}\tx\tspecies\t{s}\n" for t, s in sizes.items()))


def write_gtdb(root: str, lineages: dict, kind: str = "bac120",
               sizes: dict | None = None) -> list[str]:
    """``releases/latest/{kind}_taxonomy.tsv.gz`` (accession -> lineage,
    RS_/GB_ prefixed) and, with ``sizes``, ``{kind}_metadata.tsv.gz``."""
    folder = os.path.join(root, "releases", "latest")
    out = [_gz(os.path.join(folder, f"{kind}_taxonomy.tsv.gz"), "".join(
        f"{'RS_' if a.startswith('GCF') else 'GB_'}{a}\t{lin}\n"
        for a, lin in lineages.items()))]
    if sizes is not None:
        meta = "accession\t" + "\t".join(f"c{i}" for i in range(1, 20)) + "\n"
        for a, lin in lineages.items():
            cols = ["x"] * 20
            cols[0], cols[16], cols[19] = a, str(sizes[a]), lin
            meta += "\t".join(cols) + "\n"
        out.append(_gz(os.path.join(folder, f"{kind}_metadata.tsv.gz"), meta))
    return out


# --------------------------------------------------------------------------
# e-utils


def serve_eutils(seqs: dict, fail_first: bool = False):
    """A local e-utils endpoint. ``seqs``: accession -> (length, taxid,
    assembly uid or None, assembly accession, organism, esummary): with
    ``esummary`` False the accession is found only by efetch. Returns
    (base URL, the request log [(endpoint:db, ids, api_key)], stop());
    with
    ``fail_first`` the first request to each endpoint answers 500."""
    log: list = []
    failed: set = set()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            endpoint = url.path.rsplit("/", 1)[-1]
            key = endpoint + ":" + q.get("db", [""])[0]
            ids = [i for v in q.get("id", []) for i in v.split(",")]
            log.append((key, ids, q.get("api_key", [""])[0]))
            if fail_first and key not in failed:
                failed.add(key)
                self.send_response(500)
                self.end_headers()
                return
            body = ""
            if key == "esummary.fcgi:nuccore":
                body = "<eSummaryResult>" + "".join(
                    f'<DocSum><Item Name="AccessionVersion" Type="String">'
                    f'{a}</Item><Item Name="Length" Type="Integer">'
                    f'{seqs[a][0]}</Item><Item Name="TaxId" Type="Integer">'
                    f'{seqs[a][1]}</Item></DocSum>'
                    for a in ids if a in seqs and seqs[a][5]
                ) + "</eSummaryResult>"
            elif endpoint == "efetch.fcgi":
                body = "<TSeqSet>" + "".join(
                    f"<TSeq><TSeq_accver>{a}</TSeq_accver><TSeq_taxid>"
                    f"{seqs[a][1]}</TSeq_taxid><TSeq_length>{seqs[a][0]}"
                    "</TSeq_length></TSeq>" for a in ids if a in seqs
                ) + "</TSeqSet>"
            elif endpoint == "elink.fcgi":
                sets = []
                for a in q.get("id", []):
                    uid = seqs.get(a, (0, 0, None))[2]
                    link = (f"<LinkSetDb><LinkName>nuccore_assembly</LinkName>"
                            f"<Link><Id>{uid}</Id></Link></LinkSetDb>"
                            if uid else "")
                    sets.append(f"<LinkSet>{link}</LinkSet>")
                body = "<eLinkResult>" + "".join(sets) + "</eLinkResult>"
            elif key == "esummary.fcgi:assembly":
                docs = {}
                for a, (_, _, uid, asm, org, _) in seqs.items():
                    if uid in ids and uid not in docs:
                        docs[uid] = (
                            f'<DocumentSummary uid="{uid}"><AssemblyAccession>'
                            f"{asm}</AssemblyAccession><Organism>{org}"
                            "</Organism></DocumentSummary>")
                body = "<result>" + "".join(docs.values()) + "</result>"
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def stop():
        server.shutdown()
        server.server_close()

    return f"http://127.0.0.1:{server.server_port}", log, stop
