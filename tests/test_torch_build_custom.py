"""``build-custom`` through the port against the JAX package, on the CPU.

The data is synthesized offline from seeds: random FASTA files (some
gzipped, one in a subfolder) named by GCA_/GCF_ accessions, an NCBI
``nodes.dmp``/``names.dmp``/``merged.dmp`` and the same as
``taxdump.tar.gz``, an ``assembly_summary.txt``, an accession2taxid
file, a GTDB ``*_taxonomy.tsv.gz`` with its metadata, and an NCBI
genome-size file. Each case runs ``ganon_tpu.cli.main`` and then the
port's ``main(..., device="cpu")`` at the same database prefix and
compares every file they write: the filter (npz by arrays and header,
``tpu-raw`` and reference formats byte for byte), ``.tax``,
``.info.tsv``, ``build/target_info.tsv`` and ``config.pkl`` (as loaded
dicts). The branches that fetch run offline: ``local_dir`` points at a
copy of the files in the repository's layout (the taxdump, the genome
sizes, the GTDB taxonomy), ``--ncbi-url`` at the same tree as a
``file://`` URL (the assembly_summary and accession2taxid prefixes), and
``eutils_url`` at a local e-utils stub (``ncbi_tree.serve_eutils``).
``--convert-taxonomy`` runs in its four directions from local GTDB
conversion files (``{acc} <tab> {t|f} <tab> {lineage} <tab> {taxid}``,
one per GTDB version).
"""

import gzip
import io
import os
import pickle
import shutil
import tarfile

import numpy as np
import pytest
import torch

from ganon_tpu.cli import main as jax_main
from ganon_tpu.config import Config as JaxConfig
from ganon_tpu_torch.cli import main as port_main
from ganon_tpu_torch.config import Config as PortConfig
from ncbi_tree import serve_eutils

# accession, taxid, organism name, infraspecific name, plain .fna
ASSEMBLIES = [
    ("GCF_000001.1", "11", "Bacillus alpha", "strain=A1", False),
    ("GCA_000002.1", "12", "Bacillus beta", "", True),
    ("GCF_000003.2", "21", "Coccus gamma X1", "strain=X1", False),
    ("GCA_000004.1", "13", "Coccus delta", "isolate=Z", False),  # merged id
    ("GCF_000005.1", "99999", "Unknown thing", "", False),  # not in taxonomy
]
MORE = ("GCF_000006.1", "11", "Bacillus alpha", "strain=B2", False)
NODES = [("1", "1", "no rank"), ("2", "1", "superkingdom"),
         ("10", "2", "genus"), ("11", "10", "species"), ("12", "10", "species"),
         ("20", "2", "genus"), ("21", "20", "species"), ("22", "20", "species")]
NAMES = {"1": "root", "2": "Bacteria", "10": "Bacillus", "11": "Bacillus alpha",
         "12": "Bacillus beta", "20": "Coccus", "21": "Coccus gamma",
         "22": "Coccus delta"}
GTDB = {"GCF_000001.1": "g__Bacillus;s__Bacillus alpha",
        "GCA_000002.1": "g__Bacillus;s__Bacillus beta",
        "GCF_000003.2": "g__Coccus;s__Coccus gamma",
        "GCF_000006.1": "g__Bacillus;s__Bacillus alpha"}
GTDB_PREFIX = "d__Bacteria;p__Firmicutes;c__Bacilli;o__Bacillales;f__Bacillaceae;"


def _seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, size=n))


def _write(path, text):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("build_custom_data")
    rng = np.random.default_rng(2024)
    (d / "files" / "more").mkdir(parents=True)
    files, seqids = {}, {}
    for i, (acc, _, _, _, plain) in enumerate(ASSEMBLIES + [MORE]):
        sub = "files/more" if acc == MORE[0] else "files"
        ext = ".fna" if plain else ".fna.gz"
        ids = [f"NZ_{chr(65 + i)}{j}.1" for j in range(2)]
        seqs = [_seq(rng, 1500 + 900 * ((i + j) % 4)) for j in range(2)]
        text = "".join(f">{sid} {acc} seq {j}\n" + "\n".join(
            s[k:k + 60] for k in range(0, len(s), 60)) + "\n"
            for j, (sid, s) in enumerate(zip(ids, seqs)))
        files[acc] = _write(d / sub / f"{acc}_ASM{i}v1_genomic{ext}", text)
        seqids[acc] = ids
    nodes = "".join(f"{n}\t|\t{p}\t|\t{r}\t|\n" for n, p, r in NODES)
    names = "".join(f"{n}\t|\t{v}\t|\t\t|\tscientific name\t|\n"
                    for n, v in NAMES.items())
    merged = "13\t|\t22\t|\n"
    dmp = [_write(d / "nodes.dmp", nodes), _write(d / "names.dmp", names),
               _write(d / "merged.dmp", merged)]
    with tarfile.open(d / "taxdump.tar.gz", "w:gz") as tar:
        for name, text in (("nodes.dmp", nodes), ("names.dmp", names),
                           ("merged.dmp", merged)):
            b = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(b)
            tar.addfile(ti, io.BytesIO(b))
    summary = "#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README.txt\n" \
        "# assembly_accession\tbioproject\tbiosample\twgs_master\t" \
        "refseq_category\ttaxid\tspecies_taxid\torganism_name\t" \
        "infraspecific_name\tisolate\n"
    for acc, taxid, org, infra, _ in ASSEMBLIES + [MORE]:
        summary += f"{acc}\tPRJ\tSAM\t\tna\t{taxid}\t{taxid}\t{org}\t{infra}\t\n"
    a2t = "accession\taccession.version\ttaxid\tgi\n"
    for acc, taxid, _, _, _ in ASSEMBLIES + [MORE]:
        for j, sid in enumerate(seqids[acc]):
            t = "0" if (acc == "GCF_000003.2" and j == 1) else taxid
            a2t += f"{sid.split('.')[0]}\t{sid}\t{t}\t0\n"
    gtdb = "".join(f"{'RS_' if a.startswith('GCF') else 'GB_'}{a}\t"
                   f"{GTDB_PREFIX}{lin}\n" for a, lin in GTDB.items())
    meta = "accession\t" + "\t".join(f"c{i}" for i in range(1, 20)) + "\n"
    for i, (a, lin) in enumerate(GTDB.items()):
        cols = ["x"] * 20
        cols[0], cols[16] = a, str(3_000_000 + 1000 * i)
        cols[19] = GTDB_PREFIX + lin
        meta += "\t".join(cols) + "\n"
    gsize = "#species_taxid\tname\trank\texpected_ungapped_length\n" + \
        "".join(f"{t}\tx\tspecies\t{4_000_000 + int(t)}\n"
                for t in ("11", "12", "21", "22"))
    written = {
        "summary": _write(d / "assembly_summary.txt", summary),
        "a2t": _write(d / "nucl_gb.accession2taxid", a2t),
        "gtdb": _write(d / "bac120_taxonomy.tsv.gz", gtdb),
        "gtdb_meta": _write(d / "bac120_metadata.tsv.gz", meta),
        "gsize": _write(d / "species_genome_size.txt.gz", gsize),
    }
    repo = d / "repo"
    for src, rel in (
            (d / "taxdump.tar.gz",
             "pub/taxonomy/new_taxdump/new_taxdump.tar.gz"),
            (d / "species_genome_size.txt.gz",
             "genomes/ASSEMBLY_REPORTS/species_genome_size.txt.gz"),
            (d / "assembly_summary.txt",
             "genomes/refseq/assembly_summary_refseq.txt"),
            (d / "bac120_taxonomy.tsv.gz",
             "releases/latest/bac120_taxonomy.tsv.gz")):
        os.makedirs(repo / os.path.dirname(rel), exist_ok=True)
        shutil.copyfile(src, repo / rel)
    os.makedirs(repo / "pub/taxonomy/accession2taxid")
    _write(repo / "pub/taxonomy/accession2taxid/nucl_gb.accession2taxid.gz",
           a2t)
    # a newer taxdump (21 merged into 22) and a newer GTDB release (one
    # species renamed, one assembly dropped, one moved), with the
    # conversion files of both releases
    newer = d / "newer"
    newer.mkdir()
    nodes2 = "".join(f"{n}\t|\t{p}\t|\t{r}\t|\n" for n, p, r in NODES
                     if n != "21")
    names2 = "".join(f"{n}\t|\t{v}\t|\t\t|\tscientific name\t|\n"
                     for n, v in NAMES.items() if n != "21")
    ncbi2 = [_write(newer / "nodes.dmp", nodes2),
             _write(newer / "names.dmp", names2),
             _write(newer / "merged.dmp", "13\t|\t22\t|\n21\t|\t22\t|\n")]
    gtdb_new = {a: lin.replace("s__Bacillus alpha", "s__Bacillus alphus")
                for a, lin in GTDB.items() if a != "GCA_000002.1"}
    gtdb_new["GCF_000003.2"] = "g__Bacillus;s__Bacillus gamma"
    gtdb2 = _write(newer / "bac120_taxonomy.tsv.gz", "".join(
        f"{'RS_' if a.startswith('GCF') else 'GB_'}{a}\t{GTDB_PREFIX}{lin}\n"
        for a, lin in gtdb_new.items()))
    taxid_of = {a[0]: a[1] for a in ASSEMBLIES + [MORE]}
    # an assembly outside the inputs makes a node map to two: 95's
    # s__Bacillus alpha to taxids 11 and 12, 226's taxid 11 to two species
    taxid_of["GCF_000099.1"] = "12"
    extra = {"95": ("GCF_000099.1", "g__Bacillus;s__Bacillus alpha", "12"),
             "226": ("GCF_000099.1", "g__Bacillus;s__Bacillus beta", "11")}
    conv = [_write(d / f"{v}_acc_rep_lin_ncbi.tsv.gz", "".join(
        f"{a}\t{'t' if i % 2 else 'f'}\t{GTDB_PREFIX}{lin}\t{t}\n"
        for i, (a, lin, t) in enumerate(
            [(a, lin, taxid_of[a]) for a, lin in g.items()] + [extra[v]])))
        for v, g in (("95", GTDB), ("226", gtdb_new))]
    return {
        "repo": str(repo), "ncbi2": ncbi2, "gtdb2": gtdb2, "conv": conv,
        "dir": str(d), "files": files, "seqids": seqids,
        "dmp": dmp, "taxdump": str(d / "taxdump.tar.gz"), **written,
    }


def _outputs(prefix):
    """{relative name: bytes} of every file a build wrote at ``prefix``."""
    out = {}
    base = os.path.dirname(prefix)
    for root, _, names in os.walk(base):
        for n in names:
            p = os.path.join(root, n)
            if p.startswith(prefix):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, base)] = f.read()
    return out


def _same_filter(name, a, b):
    """npz containers by arrays and header, other formats by bytes."""
    if not a.startswith(b"PK"):
        return a == b
    za, zb = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
    return sorted(za.files) == sorted(zb.files) and all(
        np.array_equal(za[k], zb[k]) for k in za.files)


def _compare(want, got):
    assert sorted(want) == sorted(got)
    for name in want:
        if name.endswith("config.pkl"):
            assert pickle.loads(want[name]) == pickle.loads(got[name]), name
        elif name.endswith((".ibf", ".hibf")):
            assert _same_filter(name, want[name], got[name]), name
        else:
            assert want[name] == got[name], name


def _both(tmp_path, name, steps=None, **params):
    """Run JAX, then the port, at one prefix; return both outputs.
    ``steps(cfg_maker, run)`` replaces the single run when given."""
    prefix = str(tmp_path / "db" / name)
    params = {"quiet": True, "keep_files": True, **params}
    res = []
    for config, run in ((JaxConfig, lambda c: jax_main(cfg=c)),
                        (PortConfig, lambda c: port_main(cfg=c,
                                                         device="cpu"))):
        shutil.rmtree(tmp_path / "db", ignore_errors=True)
        os.makedirs(tmp_path / "db")

        def make(**over):
            return config("build-custom", db_prefix=prefix,
                          **{**params, **over})

        if steps is None:
            assert run(make())
        else:
            steps(make, run, prefix)
        res.append(_outputs(prefix))
    return res


def _input_file(tmp_path, data, ncols, sequence=False):
    rows = []
    for acc, taxid, org, _, _ in ASSEMBLIES:
        targets = data["seqids"][acc] if sequence else [acc]
        for t in targets:
            row = [data["files"][acc], t, taxid, acc + "_spec", "spec " + org]
            rows.append("\t".join(row[:ncols]))
    path = tmp_path / f"input_{ncols}_{int(sequence)}.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _input_file_edges(tmp_path, data):
    """Rows pandas' semantics decide: a specialization under two nodes
    (re-keyed to its targets), a duplicate target (first kept), a missing
    target (dropped), a missing file (skipped), a short row (no
    specialization) and an NA string."""
    f = [data["files"][a[0]] for a in ASSEMBLIES]
    rows = [
        [f[0], "T1", "11", "SPEC_A", "spec a"],
        [f[1], "T2", "21", "SPEC_A", "spec a2"],
        [f[2], "T3", "12", "SPEC_B", "NA"],
        [f[3], "T3", "22", "SPEC_C", "spec c"],
        [f[4], "", "11", "SPEC_E", "spec e"],
        [str(tmp_path / "missing.fna"), "T9", "11", "SPEC_D", "spec d"],
        [f[3], "T6", "22"],
    ]
    path = tmp_path / "input_edges.tsv"
    path.write_text("".join("\t".join(r) + "\n" for r in rows))
    return str(path)


def _ncbi(data, **kw):
    return dict(taxonomy="ncbi", taxonomy_files=data["dmp"],
                ncbi_file_info=[data["summary"]], **kw)


CASES = {
    "skip_files": lambda d, t: dict(
        input=list(d["files"].values())[:4], taxonomy="skip",
        write_info_file=True),
    "skip_folder_extension": lambda d, t: dict(
        input=[os.path.join(d["dir"], "files")], input_extension="fna.gz",
        taxonomy="skip", write_info_file=True, filter_format="tpu-raw"),
    "skip_folder_recursive": lambda d, t: dict(
        input=[os.path.join(d["dir"], "files")], input_extension="fna.gz",
        input_recursive=True, taxonomy="skip", filter_format="reference"),
    "ncbi_leaves_genome_size": lambda d, t: dict(
        input=[os.path.join(d["dir"], "files")], input_extension=".fna.gz",
        input_recursive=True, level="leaves", genome_size_files=[d["gsize"]],
        write_info_file=True, **_ncbi(d)),
    "ncbi_species_taxdump": lambda d, t: dict(
        input=list(d["files"].values()), level="species",
        skip_genome_size=True, write_info_file=True,
        **{**_ncbi(d), "taxonomy_files": [d["taxdump"]]}),
    "ncbi_assembly": lambda d, t: dict(
        input=list(d["files"].values()), level="assembly",
        skip_genome_size=True, write_info_file=True, **_ncbi(d)),
    "ncbi_genus_keep_invalid": lambda d, t: dict(
        input=list(d["files"].values()), level="genus", keep_invalid_taxa=True,
        skip_genome_size=True, write_info_file=True, **_ncbi(d)),
    "ncbi_rank_not_found": lambda d, t: dict(
        input=list(d["files"].values()), level="strain",
        skip_genome_size=True, **_ncbi(d)),
    "ncbi_sequence": lambda d, t: dict(
        input=list(d["files"].values()), input_target="sequence",
        taxonomy="ncbi", taxonomy_files=d["dmp"],
        ncbi_sequence_info=[d["a2t"]], skip_genome_size=True,
        write_info_file=True),
    "gtdb_leaves": lambda d, t: dict(
        input=list(d["files"].values()), taxonomy="gtdb",
        taxonomy_files=[d["gtdb"]], genome_size_files=[d["gtdb_meta"]],
        write_info_file=True),
    "gtdb_assembly_keep_invalid": lambda d, t: dict(
        input=list(d["files"].values()), taxonomy="gtdb", level="assembly",
        taxonomy_files=[d["gtdb"]], skip_genome_size=True,
        keep_invalid_taxa=True, write_info_file=True),
    "input_file_1col": lambda d, t: dict(
        input_file=_input_file(t, d, 1), taxonomy="skip",
        write_info_file=True),
    "input_file_2col": lambda d, t: dict(
        input_file=_input_file(t, d, 2), taxonomy="skip",
        write_info_file=True),
    "input_file_3col": lambda d, t: dict(
        input_file=_input_file(t, d, 3), taxonomy="ncbi",
        taxonomy_files=d["dmp"], skip_genome_size=True, write_info_file=True),
    "input_file_4col_custom": lambda d, t: dict(
        input_file=_input_file(t, d, 4), taxonomy="ncbi", level="custom",
        taxonomy_files=d["dmp"], skip_genome_size=True, write_info_file=True),
    "input_file_5col_custom": lambda d, t: dict(
        input_file=_input_file(t, d, 5), taxonomy="ncbi", level="custom",
        taxonomy_files=d["dmp"], genome_size_files=[d["gsize"]],
        write_info_file=True),
    "input_file_3col_species": lambda d, t: dict(
        input_file=_input_file(t, d, 3), taxonomy="ncbi", level="species",
        taxonomy_files=d["dmp"], skip_genome_size=True, write_info_file=True),
    "input_file_sequence": lambda d, t: dict(
        input_file=_input_file(t, d, 3, sequence=True),
        input_target="sequence", taxonomy="ncbi", taxonomy_files=d["dmp"],
        skip_genome_size=True, write_info_file=True),
    "input_file_edges_custom": lambda d, t: dict(
        input_file=_input_file_edges(t, d), taxonomy="ncbi", level="custom",
        taxonomy_files=d["dmp"], skip_genome_size=True, write_info_file=True),
    "input_file_edges_skip": lambda d, t: dict(
        input_file=_input_file_edges(t, d), taxonomy="skip",
        write_info_file=True),
    "hibf_forest_raw": lambda d, t: dict(
        input=list(d["files"].values()), taxonomy="skip", filter_type="hibf",
        filter_format="tpu-raw"),
    "hibf_reference": lambda d, t: dict(
        input=list(d["files"].values()), taxonomy="ncbi",
        taxonomy_files=d["dmp"], ncbi_file_info=[d["summary"]],
        skip_genome_size=True, filter_type="hibf",
        filter_format="reference"),
    "ibf_options": lambda d, t: dict(
        input=list(d["files"].values()), taxonomy="skip", hash_functions=3,
        max_fp=0.01, min_length=2000, threads=2, mode="smaller",
        tpu_sizing="off"),
    "no_keep_files": lambda d, t: dict(
        input=list(d["files"].values())[:3], taxonomy="skip",
        keep_files=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_custom_matches_jax(data, tmp_path, case):
    want, got = _both(tmp_path, case, **CASES[case](data, tmp_path))
    _compare(want, got)
    assert any(n.endswith((".ibf", ".hibf")) for n in want)


def test_build_custom_resume_and_restart(data, tmp_path):
    """A parse state skips the parse and rebuilds the filter from the
    kept target_info; --restart starts over."""
    def steps(make, run, prefix):
        assert run(make())
        os.remove(prefix + ".ibf")
        folder = prefix + "_files/"
        open(folder + ".build_custom_parse", "w").close()
        # new inputs are not read while the parse state stands
        assert run(make(input=list(data["files"].values())[:2]))
        assert os.path.exists(prefix + ".ibf")
        open(folder + ".build_custom_parse", "w").close()
        open(folder + ".build_custom_run", "w").close()
        assert run(make(input=list(data["files"].values())[:2],
                        restart=True))

    want, got = _both(tmp_path, "resume", steps=steps, taxonomy="skip",
                      write_info_file=True,
                      input=list(data["files"].values()))
    _compare(want, got)
    # the restart saw the two new inputs
    ti = [v for k, v in got.items() if k.endswith("target_info.tsv")][0]
    assert ti.count(b"\n") == 2


@pytest.fixture(scope="module")
def eutils(data):
    """An e-utils stub that knows every sequence of the data: the first of
    each assembly through esummary, the second only through efetch; its
    assembly through elink."""
    seqs = {}
    for i, (acc, taxid, org, _, _) in enumerate(ASSEMBLIES + [MORE]):
        for j, sid in enumerate(data["seqids"][acc]):
            seqs[sid] = (2000 + j, taxid, str(500 + i), acc, org, j == 0)
    url, _, stop = serve_eutils(seqs)
    yield url
    stop()


@pytest.fixture
def offline(data, eutils, tmp_path, monkeypatch):
    """Every fetch served locally; the working directory a temporary one
    (the JAX package fetches --convert-taxonomy's taxonomy into it)."""
    monkeypatch.setenv("local_dir", data["repo"])
    monkeypatch.setenv("eutils_url", eutils)
    monkeypatch.chdir(tmp_path)
    return data


def _offline_cases(data):
    files = list(data["files"].values())
    url = "file://" + data["repo"] + "/"
    return {
        "taxonomy_download": dict(input=files, taxonomy="ncbi",
                                  ncbi_file_info=[data["summary"]],
                                  skip_genome_size=True, write_info_file=True),
        "assembly_summary_prefix": dict(input=files, taxonomy="ncbi",
                                        taxonomy_files=data["dmp"],
                                        ncbi_file_info=["refseq"],
                                        ncbi_url=url, level="assembly",
                                        skip_genome_size=True,
                                        write_info_file=True),
        "eutils_auto": dict(input=files, input_target="sequence",
                            taxonomy="ncbi", taxonomy_files=data["dmp"],
                            skip_genome_size=True, write_info_file=True),
        "acc2txid_prefix": dict(input=files, input_target="sequence",
                                taxonomy="ncbi", taxonomy_files=data["dmp"],
                                ncbi_sequence_info=["nucl_gb"], ncbi_url=url,
                                skip_genome_size=True, write_info_file=True),
        "assembly_eutils": dict(input=files, input_target="sequence",
                                taxonomy="ncbi", level="assembly",
                                taxonomy_files=data["dmp"],
                                ncbi_sequence_info=[data["a2t"]],
                                skip_genome_size=True, write_info_file=True),
        "genome_size_fetch": dict(input=files, taxonomy="ncbi",
                                  taxonomy_files=data["dmp"],
                                  ncbi_file_info=[data["summary"]],
                                  write_info_file=True),
        "convert_taxonomy": dict(input=files, taxonomy="ncbi",
                                 taxonomy_files=data["dmp"],
                                 ncbi_file_info=[data["summary"]],
                                 skip_genome_size=True,
                                 convert_taxonomy="gtdb",
                                 convert_gtdb_files=[data["conv"][0]],
                                 write_info_file=True, keep_files=False),
    }


@pytest.mark.parametrize("case", [
    "taxonomy_download", "assembly_summary_prefix", "eutils_auto",
    "acc2txid_prefix", "assembly_eutils", "genome_size_fetch",
    "convert_taxonomy",
])
def test_build_custom_offline_matches_jax(offline, tmp_path, case):
    """Each branch that fetches, served offline, equals the JAX package's
    run file for file."""
    want, got = _both(tmp_path, case, **_offline_cases(offline)[case])
    _compare(want, got)
    assert any(n.endswith(".tax") for n in want)


def _convert_cases(data):
    files = list(data["files"].values())
    gtdb = dict(input=files, taxonomy="gtdb", taxonomy_files=[data["gtdb"]],
                skip_genome_size=True, write_info_file=True)
    ncbi = dict(input=files, taxonomy="ncbi", taxonomy_files=data["dmp"],
                ncbi_file_info=[data["summary"]], skip_genome_size=True,
                write_info_file=True)
    conv95, conv226 = data["conv"]
    return {
        "ncbi_ncbi": dict(**ncbi, convert_taxonomy="ncbi",
                          convert_taxonomy_files=data["ncbi2"]),
        "ncbi_ncbi_latest_fetched": dict(
            **{**ncbi, "taxonomy_files": []}, convert_taxonomy="ncbi-latest"),
        "gtdb_gtdb": dict(**gtdb, convert_taxonomy="gtdb-226",
                          convert_taxonomy_files=[data["gtdb2"]],
                          convert_gtdb_files=[conv95, conv226]),
        "gtdb_ncbi": dict(**gtdb, convert_taxonomy="ncbi",
                          convert_taxonomy_files=data["dmp"],
                          convert_gtdb_files=[conv95]),
        "gtdb_ncbi_genus": dict(**{**gtdb, "level": "genus"},
                                convert_taxonomy="ncbi",
                                convert_taxonomy_files=data["ncbi2"],
                                convert_gtdb_files=[conv95]),
        "gtdb_ncbi_fetched": dict(**{**gtdb, "keep_files": False},
                                  convert_taxonomy="ncbi",
                                  convert_gtdb_files=[conv95]),
        "ncbi_gtdb": dict(**ncbi, convert_taxonomy="gtdb-226",
                          convert_taxonomy_files=[data["gtdb2"]],
                          convert_gtdb_files=[conv226]),
        "ncbi_gtdb_assembly": dict(**{**ncbi, "level": "assembly"},
                                   convert_taxonomy="gtdb",
                                   convert_taxonomy_files=[data["gtdb"]],
                                   convert_gtdb_files=[conv95]),
    }


@pytest.mark.parametrize("case", [
    "ncbi_ncbi", "ncbi_ncbi_latest_fetched", "gtdb_gtdb", "gtdb_ncbi",
    "gtdb_ncbi_genus", "gtdb_ncbi_fetched", "ncbi_gtdb", "ncbi_gtdb_assembly",
])
def test_convert_taxonomy_matches_jax(offline, tmp_path, case):
    want, got = _both(tmp_path, case, **_convert_cases(offline)[case])
    _compare(want, got)
    tax = [v for k, v in got.items() if k.endswith(".tax")][0].decode()
    target = _convert_cases(offline)[case]["convert_taxonomy"]
    # the database is on the target taxonomy
    assert ("s__" in tax) == target.startswith("gtdb")
    cfg = pickle.loads([v for k, v in got.items()
                        if k.endswith("config.pkl")][0])
    assert cfg["taxonomy"] == target


@pytest.mark.parametrize("pair", [("gtdb", "gtdb"), ("gtdb", "ncbi"),
                                  ("ncbi", "gtdb")])
def test_convert_without_gtdb_files_raises(offline, tmp_path, pair):
    """The GTDB directions need --convert-gtdb-files: the same ValueError
    in both packages."""
    src, dst = pair
    files = list(offline["files"].values())
    params = dict(input=files, taxonomy=src, skip_genome_size=True,
                  convert_taxonomy=dst, quiet=True,
                  taxonomy_files=(offline["dmp"] if src == "ncbi"
                                  else [offline["gtdb"]]),
                  ncbi_file_info=[offline["summary"]])
    errors = []
    for config, run in ((JaxConfig, lambda c: jax_main(cfg=c)),
                        (PortConfig, lambda c: port_main(cfg=c,
                                                         device="cpu"))):
        with pytest.raises(ValueError, match="--convert-gtdb-files") as e:
            run(config("build-custom", db_prefix=str(tmp_path / config.__module__
                                                     / "x"), **params))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_build_custom_default_device_needs_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = PortConfig("build-custom", db_prefix=str(tmp_path / "db" / "x"),
                     quiet=True, taxonomy="skip",
                     input=list(data["files"].values()))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(cfg=cfg)
    assert not (tmp_path / "db").exists()
