"""EM reassignment, reports and tables: the port against ``ganon_tpu``.

``ganon_tpu_torch.reassign`` (its ``.all`` reader written with the
``csv`` module where the JAX package calls pandas), and the copies
``ganon_tpu_torch.report.report`` / ``.table``, run on the same seeded
inputs as the JAX package's: every file they write must be byte-equal
(tied probabilities, hierarchies, ``remove_all``, ``output_prefix``, an
empty classification). Reports run every ``--report-type`` in every
``--output-format`` and a set of filters, through both packages' CLI
entry (``main("report", ...)``), on ``.rep`` files the test writes (the
reference's fixtures are not needed). Last, the port's CLI ``classify``
at its default flags (EM, the report chained from the database's
``.tax``) against ``ganon_tpu.cli`` on the CPU: equal ``.rep``, ``.one``,
``.tre`` and ``.all`` after sorting rows.
"""

import os
import random

import pytest

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu import cli as jax_cli
from ganon_tpu.reassign import ReassignConfig as JaxReassignConfig
from ganon_tpu.reassign import reassign as jax_reassign
from ganon_tpu_torch import cli as port_cli
from ganon_tpu_torch.reassign import ReassignConfig, reassign
from tests.test_classify import build_db, read_tsv, write_fastq
from tests.test_torch_engine import _families, _paired_reads, _tax


def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(str(v) for v in r) + "\n")


def _dir_files(d):
    return {fn: (d / fn).read_bytes() for fn in sorted(os.listdir(d))}


def _assert_same_dirs(a, b):
    fa, fb = _dir_files(a), _dir_files(b)
    assert sorted(fa) == sorted(fb)
    for fn in fa:
        assert fa[fn] == fb[fn], fn


# --------------------------------------------------------------------------
# reassign


def _classification(rng, hierarchy, n_reads, n_targets, *, ties=False,
                    unique=True):
    """(.all rows, .rep rows) of one hierarchy: reads with one to four
    matches; ``ties`` gives every target the same unique count, so
    multi-match reads tie and the first match in file order wins;
    ``unique=False`` leaves no unique read at all."""
    targets = [f"{hierarchy}T{t}" for t in range(n_targets)]
    rows = []
    for i in range(n_reads):
        if ties and i < 2 * n_targets:
            hit = [targets[i % n_targets]]
        else:
            lo = 1 if unique and not ties else 2
            hit = rng.sample(targets, rng.randint(lo, min(4, n_targets)))
        k = rng.randint(20, 90)
        rows += [(f"{hierarchy}r{i}", t, k - rng.randint(0, 3)) for t in hit]
    direct = {t: 0 for t in targets}
    uniq = {t: 0 for t in targets}
    per_read = {}
    for r, t, _ in rows:
        direct[t] += 1
        per_read.setdefault(r, []).append(t)
    for ts in per_read.values():
        if len(ts) == 1:
            uniq[ts[0]] += 1
    rep = [(hierarchy, t, direct[t], uniq[t], 0, "species", t)
           for t in targets if direct[t]]
    lca = sum(len(ts) > 1 for ts in per_read.values())
    rep.append((hierarchy, "1", 0, 0, lca, "root", "root"))
    return rows, rep, len(per_read)


def _write_case(d, case):
    """The inputs of one reassign case in ``d``; returns its config
    fields (prefixes relative to ``d``)."""
    rng = random.Random(case)
    hier = ["H1", "H2"] if case == "hierarchies" else ["H1"]
    n = {"random": 400, "max-iter-0": 400, "threshold": 400}.get(case, 60)
    kw = dict(ties=case == "ties", unique=case != "no-unique")
    reps = ["s1", "s2"] if case == "two-reps" else ["res"]
    for name in reps:
        rep_rows, total = [], 0
        for h in hier:
            all_rows, rep, n_cls = _classification(rng, h, n, 9, **kw)
            if case == "empty":
                all_rows, rep, n_cls = [], [], 0
            suffix = f".{h}.all" if len(hier) > 1 else ".all"
            _write_rows(d / f"{name}{suffix}", all_rows)
            rep_rows += rep
            total += n_cls
        _write_rows(d / f"{name}.rep", rep_rows + [
            ("#total_classified", total), ("#total_unclassified", 7)])
    cfg = dict(input_prefix=["res"], max_iter=10, threshold=0.0)
    if case == "two-reps":
        cfg.update(input_prefix=["s"], output_prefix="out_")
    elif case == "output-prefix":
        cfg.update(output_prefix="elsewhere")
    elif case == "remove-all":
        cfg.update(remove_all=True)
    elif case == "skip-one":
        cfg.update(skip_one=True)
    elif case == "skip-rep":
        cfg.update(skip_rep=True)
    elif case == "max-iter-0":
        cfg.update(max_iter=0, threshold=1e-6)
    elif case == "threshold":
        cfg.update(max_iter=50, threshold=0.05)
    return cfg


@pytest.mark.parametrize("case", [
    "random", "ties", "no-unique", "hierarchies", "two-reps",
    "output-prefix", "remove-all", "skip-one", "skip-rep", "max-iter-0",
    "threshold", "empty"])
def test_reassign_matches_jax(tmp_path, monkeypatch, case):
    outs = {}
    for name, cfg_cls, fn in (("jax", JaxReassignConfig, jax_reassign),
                              ("port", ReassignConfig, reassign)):
        d = tmp_path / name
        d.mkdir()
        kw = _write_case(d, case)
        monkeypatch.chdir(d)
        assert fn(cfg_cls(**kw))
        outs[name] = d
    _assert_same_dirs(outs["jax"], outs["port"])
    files = set(os.listdir(outs["port"]))
    if case == "remove-all":
        assert not any(f.endswith(".all") for f in files)
    if case == "two-reps":
        assert {"out_s1.one", "out_s2.rep"} <= files
    if case == "hierarchies":
        assert {"res.H1.one", "res.H2.one"} <= files
    if case in ("random", "ties"):
        assert read_tsv(outs["port"] / "res.one")


def test_reassign_ties_take_the_first_match(tmp_path):
    """Equal probabilities: the first match in file order wins."""
    _write_rows(tmp_path / "t.all", [
        ("u1", "A", 9), ("u2", "B", 9),
        ("m1", "B", 5), ("m1", "A", 5), ("m2", "A", 4), ("m2", "B", 4)])
    _write_rows(tmp_path / "t.rep", [
        ("H1", "A", 3, 1, 0), ("H1", "B", 3, 1, 0),
        ("#total_classified", 4), ("#total_unclassified", 0)])
    assert reassign(ReassignConfig(input_prefix=[str(tmp_path / "t")]))
    one = {r[0]: r[1] for r in read_tsv(tmp_path / "t.one")}
    assert one == {"u1": "A", "u2": "B", "m1": "B", "m2": "A"}


def test_reassign_empty_all_file(tmp_path):
    """A ``.rep`` that lists targets beside an empty ``.all`` (pandas
    raises on it in the JAX package): an empty ``.one`` and the ``.rep``
    trailer alone."""
    (tmp_path / "e.all").write_text("")
    _write_rows(tmp_path / "e.rep", [
        ("H1", "A", 0, 0, 0), ("#total_classified", 0),
        ("#total_unclassified", 5)])
    assert reassign(ReassignConfig(input_prefix=[str(tmp_path / "e")]))
    assert (tmp_path / "e.one").read_text() == ""
    assert (tmp_path / "e.rep").read_text() == (
        "#total_classified\t0\n#total_unclassified\t5\n")


def test_reassign_cli_matches_jax(tmp_path, monkeypatch):
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / name
        d.mkdir()
        _write_case(d, "random")
        monkeypatch.chdir(d)
        assert main("reassign", input_prefix=["res"], output_prefix="cli",
                    max_iter=3, remove_all=True, quiet=True)
        outs[name] = d
    _assert_same_dirs(outs["jax"], outs["port"])
    assert (outs["port"] / "cli.one").exists()


# --------------------------------------------------------------------------
# report and table


def _taxonomy(path):
    """root > 2 phyla > 4 genera > 10 species > 4 assemblies, with a
    genome size (the fifth column) on every node."""
    rows = [("1", "0", "root", "root", "4000000"),
            ("D", "1", "domain", "Bacteria", "3900000")]
    for p in range(2):
        rows.append((f"P{p}", "D", "phylum", f"Phylum {p}",
                     str(3_500_000 + p * 100_000)))
    for g in range(4):
        rows.append((f"G{g}", f"P{g % 2}", "genus", f"Genus {g}",
                     str(3_000_000 + g * 250_000)))
    for s in range(10):
        rows.append((f"S{s}", f"G{s % 4}", "species", f"Species {s}",
                     str(1_000_000 + s * 137_000)))
    for a in range(4):
        rows.append((f"A{a}", f"S{a}", "assembly", f"Assembly {a}",
                     str(2_000_000 + a * 91_000)))
    _write_rows(path, rows)


def _reports(d, n_samples=3):
    """Seeded ``.rep`` files of two hierarchies (unique and LCA reads on
    leaves, LCA reads on genera and phyla, a target not in the
    taxonomy); returns their paths."""
    _taxonomy(d / "db.tax")
    paths = []
    for s in range(n_samples):
        rng = random.Random(100 + s)
        rows, total = [], 0
        for h in ("H1", "H2"):
            leaves = [f"S{i}" for i in range(4, 10)] + [
                f"A{i}" for i in range(4)]
            for t in rng.sample(leaves, 7):
                u, lca = rng.randint(0, 400), rng.randint(0, 60)
                rows.append((h, t, u + lca + rng.randint(0, 90), u, lca,
                             "species", t))
                total += u + lca
            for t in ("G1", "G2", "P0"):
                lca = rng.randint(1, 120)
                rows.append((h, t, lca * 2, 0, lca, "genus", t))
                total += lca
        rows.append(("H2", "X9", 10, 4, 0, "species", "X9"))
        total += 4
        p = d / f"sample{s}.rep"
        _write_rows(p, rows + [("#total_classified", total),
                               ("#total_unclassified", rng.randint(0, 500))])
        paths.append(str(p))
    return paths


def _run_both(tmp_path, monkeypatch, sub, **kw):
    """``sub`` through both packages' CLI entry in twin directories of
    seeded reports; returns the two directories."""
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / name
        d.mkdir()
        _reports(d)
        monkeypatch.chdir(d)
        assert main(sub, quiet=True, **kw)
        outs[name] = d
    return outs


@pytest.mark.parametrize("fmt", ["tsv", "csv", "text", "bioboxes"])
@pytest.mark.parametrize("rtype", ["abundance", "reads", "matches", "dist",
                                   "corr"])
def test_report_matches_jax(tmp_path, monkeypatch, rtype, fmt):
    outs = _run_both(tmp_path, monkeypatch, "report",
                     input=["sample0.rep"], output_prefix="out",
                     db_prefix=["db"], report_type=rtype, output_format=fmt)
    _assert_same_dirs(outs["jax"], outs["port"])
    assert (outs["port"] / "out.tre").stat().st_size > 0


@pytest.mark.parametrize("opts", [
    dict(ranks=["all"]), dict(ranks=["genus", "species"]),
    dict(split_hierarchy=True), dict(skip_hierarchy=["H2"]),
    dict(keep_hierarchy=["H2"]), dict(min_count=50),
    dict(max_count=0.2), dict(top_percentile=0.4), dict(taxids=["G1"]),
    dict(names=["Species 5"]), dict(names_with=["Genus"]),
    dict(no_orphan=True), dict(normalize=True), dict(sort="rank"),
    dict(sort="lineage"), dict(skip_genome_size=True, db_prefix=[],
                               taxonomy="skip"),
], ids=lambda o: "-".join(f"{k}" for k in o))
def test_report_filters_match_jax(tmp_path, monkeypatch, opts):
    kw = dict(input=["sample0.rep", "sample1.rep"], output_prefix="f_",
              db_prefix=["db"], report_type="reads") | opts
    outs = _run_both(tmp_path, monkeypatch, "report", **kw)
    _assert_same_dirs(outs["jax"], outs["port"])


@pytest.mark.parametrize("opts", [
    dict(), dict(output_value="percentage"), dict(output_format="csv"),
    dict(rank="genus"), dict(header="taxid"), dict(header="lineage"),
    dict(transpose=True), dict(no_root=True), dict(skip_zeros=True),
    dict(unclassified_label="unc", filtered_label="flt"),
    dict(top_sample=2), dict(top_all=3), dict(min_frequency=2),
    dict(min_count=30), dict(max_count=0.5), dict(names_with=["Species"]),
], ids=lambda o: "-".join(f"{k}" for k in o) or "defaults")
def test_table_matches_jax(tmp_path, monkeypatch, opts):
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        reps = _reports(d)
        # the .tre inputs come from one package (the JAX one) for both
        for i, rep in enumerate(reps):
            assert jax_cli.main("report", input=[rep], db_prefix=["db"],
                                output_prefix=f"t{i}", report_type="reads",
                                ranks=["all"], quiet=True)
        kw = dict(rank="species") | opts
        assert main("table", input=["t0.tre", "t1.tre", "t2.tre"],
                    output_file="table.tsv", quiet=True, **kw)
        outs[name] = d
    _assert_same_dirs(outs["jax"], outs["port"])
    assert (outs["port"] / "table.tsv").stat().st_size > 0


# --------------------------------------------------------------------------
# classify at the CLI's default flags


@pytest.fixture(scope="module")
def em_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("em")
    rng = random.Random(77)
    refs = _families(rng, 10, 3, core=600, own=700)
    build_db(tmp, refs, k=19, w=31, max_fp=0.05)
    # the .tax as build-custom writes it: a genome size on every node
    _write_rows(tmp / "db.tax", [
        (*row, str(len(refs[row[0]]) if row[0] in refs else 5000))
        for row in read_tsv(_tax(tmp / "db.tax", refs, 3))])
    r1, r2 = _paired_reads(rng, refs, 120, w=31)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    return tmp


@pytest.mark.parametrize("flags", [
    dict(output_one=True),
    dict(output_one=True, output_all=True, report_type="reads",
         ranks=["all"]),
    dict(output_all=True, skip_report=True),
], ids=["defaults", "all-reads-report", "skip-report"])
def test_classify_cli_default_flags_match_jax(tmp_path, em_db, flags):
    """``classify`` without ``--multiple-matches`` (em) and without
    ``--skip-report`` (the database has a ``.tax``)."""
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, {}),
                              ("port", port_cli.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        assert main("classify", db_prefix=[str(em_db / "db")],
                    paired_reads=[str(em_db / "r1.fq"), str(em_db / "r2.fq")],
                    output_prefix=str(d / "o"), quiet=True, **flags, **extra)
        outs[name] = d
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files
    for fn in files:
        assert (sorted(map(tuple, read_tsv(outs["port"] / fn)))
                == sorted(map(tuple, read_tsv(outs["jax"] / fn)))), fn
    want = {"o.rep"} | ({"o.all"} if flags.get("output_all") else set())
    want |= {"o.one"} if flags.get("output_one") else set()
    want |= set() if flags.get("skip_report") else {"o.tre"}
    assert set(files) == want
    # EM assigns every classified read to one target
    if flags.get("output_one"):
        one = read_tsv(outs["port"] / "o.one")
        assert one and len({r[0] for r in one}) == len(one)


def test_classify_cli_batch_reads_prefixes(tmp_path, em_db):
    """``--batch-reads``: reassign and report run once per prefix."""
    outs = {}
    rows = [f"s{i}\t{em_db / 'r1.fq'}\t{em_db / 'r2.fq'}" for i in range(2)]
    (tmp_path / "batch.tsv").write_text("\n".join(rows) + "\n")
    for name, main, extra in (("jax", jax_cli.main, {}),
                              ("port", port_cli.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        assert main("classify", db_prefix=[str(em_db / "db")],
                    batch_reads=[str(tmp_path / "batch.tsv")],
                    output_prefix=str(d / "b_"), output_one=True, quiet=True,
                    **extra)
        outs[name] = d
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files
    assert {"b_s0.tre", "b_s1.one"} <= set(files)
    for fn in files:
        assert (sorted(map(tuple, read_tsv(outs["port"] / fn)))
                == sorted(map(tuple, read_tsv(outs["jax"] / fn)))), fn
