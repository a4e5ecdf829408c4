"""The reference's own databases: the port against ``ganon_tpu``.

The codec (``index/serialize.py``): the port's cereal ``.ibf`` and raptor
``.hibf`` writers give the JAX writers' bytes, each package reads the
other's files to equal arrays, in both sdsl variants (with and without
the width byte) and both orders of the seqan3 shape, names unmangled,
and broken archives raise the same errors. ``RaptorHIBF.hashes_count``
(the occupancy estimate) and ``DeviceRaptorHIBF.counts`` (count in
column-max mode, plain version) equal JAX's on hand layouts: a merged-only
root, a root with user and merged bins, user bins split over several
technical bins, a user bin in two IBFs, a routing-only IBF, hash
function counts that differ between IBFs, and ``bin_to_filename``
vectors shorter than the technical bins. ``classify_batch_packed`` on a
raptor filter returns JAX's ``classify_batch_packed_raptor`` int32 buffer
exactly (``pack16``, ``match_cap=0``), and
``run_classify`` on a raptor ``.hibf`` or a cereal ``.ibf`` writes the
JAX engine's files (sorted rows, ``.sta`` byte for byte) alone, with
compaction overflow, with device thresholding off, in a two-level
hierarchy and beside a flat filter; the CLI reaches both formats. All
exact: counts are integers (tolerance 0).
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.classify import engine as jax_engine
from ganon_tpu.index import serialize as jser
from ganon_tpu.index.hibf import RaptorHIBF as JaxRaptorHIBF
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.hibf import export_raptor_hibf as jax_export
from ganon_tpu.index.ibf import IBF as JaxIBF
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.classify import engine as port_engine
from ganon_tpu_torch.index import serialize as tser
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.hibf import (
    RaptorHIBF,
    build_hibf,
    export_raptor_hibf,
)
from ganon_tpu_torch.index.ibf import IBF, build_ibf
from raptor_layout import write_raptor_layout
from tests.test_classify import read_tsv, write_fastq
from tests.test_torch_device import _batch
from tests.test_torch_engine import run_both
from tests.test_torch_hierarchy import _reads
from tests.test_torch_index import _assert_same_ibf

K, W = 19, 31
# skewed lengths: the largest targets split over several technical bins
LENGTHS = (1500, 1700, 2500, 3000, 6000, 7000, 16000, 20000)
NAMES = ("GCF_0.1", "s__Some species", "F2", "F3", "F4", "F5", "F6", "F7")

# (users, children) per IBF, IBF 0 the root
LAYOUTS = {
    "merged-only-root": [([], [1, 2]), (NAMES[:4], []), (NAMES[4:], [])],
    # F7 splits over many technical bins beside the small root bins
    "root-users-and-merged": [(("F7",) + NAMES[:3], [1]), (("F3", "F5"), [])],
    "user-bin-in-two-ibfs": [(("F7", "F6", "GCF_0.1"), [1]),
                             (NAMES[:6], [])],
    "routing-only-ibf": [(("F7",), [1]), ((), [2, 3]), (NAMES[:3], []),
                         (NAMES[3:7], [])],
}
# the hash function count of each IBF of a layout (0: the sizing's)
HASH_FUNCTIONS = {"root-users-and-merged": [0, 3],
                  "user-bin-in-two-ibfs": [2, 0]}


def _genomes(seed=31, k=K, w=W):
    rng = np.random.default_rng(seed)
    codes = {t: rng.integers(0, 4, size=n, dtype=np.uint8)
             for t, n in zip(NAMES, LENGTHS)}
    ex = _HashExtractor(k, w, device="cpu")
    for t, g in codes.items():
        ex.add_encoded(t, g)
    return codes, ex.finish()


@pytest.fixture(scope="module")
def genomes():
    return _genomes()


def _write_layout(path, hashes, name, k=K, w=W, short_b2f=False):
    write_raptor_layout(hashes, LAYOUTS[name], path, kmer_size=k,
                        window_size=w, max_fp=0.05,
                        hash_functions=HASH_FUNCTIONS.get(name, 0),
                        device="cpu")
    if short_b2f:  # cut each bin_to_filename to the IBF's used bins
        p = tser.read_raptor_hibf(path)
        b2fs = [b[:bins] for b, (_, bins, _, _) in
                zip(p["bin_to_filename"], p["ibfs"])]
        tser.write_raptor_hibf(
            path, window_size=w, kmer_size=k, fpr=p["fpr"],
            filenames=p["raw_filenames"],
            ibfs=[(b, n, h) for b, n, _, h in p["ibfs"]],
            next_ibf_id=p["next_ibf_id"], bin_to_filename=b2fs)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory, genomes):
    tmp = tmp_path_factory.mktemp("raptor")
    out = {}
    for name in LAYOUTS:
        out[name] = str(tmp / f"{name}.hibf")
        _write_layout(out[name], genomes[1], name)
    out["short-b2f"] = str(tmp / "short-b2f.hibf")
    _write_layout(out["short-b2f"], genomes[1], "root-users-and-merged",
                  short_b2f=True)
    return out


def _raptor_bytes(p, width_byte=False, swap_shape=False, compressed=0):
    """A parsed archive re-serialized by hand in one of the variants the
    readers accept (sdsl width byte, shape order) or refuse (compressed)."""
    out = bytearray(struct.pack("<IQ", 3, p["window_size"]))
    shape = (p["kmer_size"], (1 << p["kmer_size"]) - 1)
    out += struct.pack("<QQ", *(shape[::-1] if swap_shape else shape))
    out += bytes([1, compressed])
    out += struct.pack("<Q", len(p["raw_filenames"]))
    for f in p["raw_filenames"]:
        out += struct.pack("<QQ", 1, len(f)) + f.encode()
    out += struct.pack("<d", p["fpr"]) + bytes([1])
    out += struct.pack("<Q", len(p["ibfs"]))
    for bits, bins, size, h in p["ibfs"]:
        tb = bits.shape[1] * 32
        out += struct.pack("<QQQQQQQ", bins, tb, size, 64 - size.bit_length(),
                           tb // 64, h, tb * size)
        out += (bytes([1]) if width_byte else b"") + bits.tobytes()
    for vecs, names in ((p["next_ibf_id"], None), (None, p["raw_filenames"]),
                        (p["bin_to_filename"], None)):
        if names is not None:
            out += struct.pack("<Q", len(names))
            for f in names:
                out += struct.pack("<Q", len(f)) + f.encode()
            continue
        out += struct.pack("<Q", len(vecs))
        for v in vecs:
            out += struct.pack("<Q", len(v)) + v.astype("<i8").tobytes()
    return bytes(out)


def _assert_same_parsed(a, b):
    assert {k: v for k, v in a.items()
            if k not in ("ibfs", "next_ibf_id", "bin_to_filename")} == {
        k: v for k, v in b.items()
        if k not in ("ibfs", "next_ibf_id", "bin_to_filename")}
    assert len(a["ibfs"]) == len(b["ibfs"])
    for x, y in zip(a["ibfs"], b["ibfs"]):
        assert np.array_equal(x[0], y[0]) and x[1:] == y[1:]
    for key in ("next_ibf_id", "bin_to_filename"):
        assert len(a[key]) == len(b[key])
        assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))


# --------------------------------------------------------------------------
# the codec


@pytest.fixture(scope="module")
def flat_ibf(genomes):
    return build_ibf(genomes[1], kmer_size=K, window_size=W, max_fp=0.05,
                     device="cpu")


def test_cereal_ibf_matches_jax(tmp_path, flat_ibf):
    """Byte-equal writers, cross reads, both sdsl variants, IBF.load's
    sniffing, the sniffers and the truncated-archive error."""
    ours, theirs = str(tmp_path / "port.ibf"), str(tmp_path / "jax.ibf")
    tser.write_ibf(flat_ibf, ours)
    jibf = JaxIBF(flat_ibf.bits, flat_ibf.ibf_config, flat_ibf.hashes_count,
                  flat_ibf.bin_map)
    jser.write_ibf(jibf, theirs)
    raw = open(ours, "rb").read()
    assert raw == open(theirs, "rb").read()
    _assert_same_ibf(tser.read_ibf(theirs), flat_ibf)
    _assert_same_ibf(IBF.load(theirs), flat_ibf)
    _assert_same_ibf(jser.read_ibf(ours), flat_ibf)
    # without the sdsl width byte (it sits just before the words)
    n_words = flat_ibf.bits.size // 2
    nowidth = str(tmp_path / "nowidth.ibf")
    open(nowidth, "wb").write(raw[:-n_words * 8 - 1] + raw[-n_words * 8:])
    _assert_same_ibf(tser.read_ibf(nowidth), flat_ibf)
    _assert_same_ibf(jser.read_ibf(nowidth), flat_ibf)
    npz = str(tmp_path / "n.ibf")
    flat_ibf.save(npz)
    assert tser.is_cereal_ibf(ours) and not tser.is_cereal_ibf(npz)
    junk = str(tmp_path / "g.ibf")
    open(junk, "wb").write(b"\x00" * 7)
    assert not tser.is_cereal_ibf(junk)
    for cut in (len(raw) // 2, len(raw) - 3):
        bad = str(tmp_path / "bad.ibf")
        open(bad, "wb").write(raw[:cut])
        with pytest.raises(ValueError) as ours_e:
            tser.read_ibf(bad)
        with pytest.raises(ValueError) as theirs_e:
            jser.read_ibf(bad)
        assert str(ours_e.value) == str(theirs_e.value)
    with pytest.raises(ValueError, match="unrecognized IBF file format"):
        IBF.load(junk)


@pytest.mark.parametrize("name", sorted(LAYOUTS) + ["short-b2f"])
def test_raptor_codec_matches_jax(tmp_path, layouts, name):
    path = layouts[name]
    raw = open(path, "rb").read()
    p, jp = tser.read_raptor_hibf(path), jser.read_raptor_hibf(path)
    _assert_same_parsed(p, jp)
    assert tser.is_raptor_hibf(path) and jser.is_raptor_hibf(path)
    again = str(tmp_path / "again.hibf")
    for writer in (tser.write_raptor_hibf, jser.write_raptor_hibf):
        writer(again, window_size=W, kmer_size=K, fpr=p["fpr"],
               filenames=p["raw_filenames"],
               ibfs=[(b, n, h) for b, n, _, h in p["ibfs"]],
               next_ibf_id=p["next_ibf_id"],
               bin_to_filename=p["bin_to_filename"])
        assert open(again, "rb").read() == raw
    assert _raptor_bytes(p) == raw
    for width_byte in (False, True):
        for swap in (False, True):
            v = str(tmp_path / f"v{width_byte}{swap}.hibf")
            open(v, "wb").write(_raptor_bytes(p, width_byte, swap))
            _assert_same_parsed(tser.read_raptor_hibf(v), p)
            _assert_same_parsed(jser.read_raptor_hibf(v), p)


def test_raptor_names_unmangled(tmp_path, genomes):
    """``.minimiser`` suffix and directories dropped, ``|||`` -> ``.``,
    ``---`` -> `` `` (GanonClassify.cpp:920-928), as JAX reads them."""
    path = str(tmp_path / "n.hibf")
    _write_layout(path, genomes[1], "merged-only-root")
    p = tser.read_raptor_hibf(path)
    assert p["targets"][:2] == ["GCF_0.1", "s__Some species"]
    assert p["raw_filenames"][:2] == ["GCF_0|||1.minimiser",
                                      "s__Some---species.minimiser"]
    names = ["dir/a|||b---c.minimiser.gz", "plain", "x.minimiser"]
    p["raw_filenames"] = names + p["raw_filenames"][3:]
    open(path, "wb").write(_raptor_bytes(p))
    got = tser.read_raptor_hibf(path)
    assert got["targets"][:3] == ["a.b c", "plain", "x"]
    assert got["targets"] == jser.read_raptor_hibf(path)["targets"]


def test_raptor_corrupt_archives_raise_as_jax(tmp_path, layouts):
    raw = open(layouts["root-users-and-merged"], "rb").read()
    p = tser.read_raptor_hibf(layouts["root-users-and-merged"])
    cases = {
        "truncated": raw[:len(raw) // 2],
        "trailing": raw + b"\x00" * 8,
        "compressed": _raptor_bytes(p, compressed=1),
        "version": struct.pack("<I", 5000) + raw[4:],
        "shape": raw[:12] + struct.pack("<QQ", 70, 1 << 71 - 64) + raw[28:],
    }
    for case, data in cases.items():
        bad = str(tmp_path / f"{case}.hibf")
        open(bad, "wb").write(data)
        with pytest.raises(ValueError) as ours:
            tser.read_raptor_hibf(bad)
        with pytest.raises(ValueError) as theirs:
            jser.read_raptor_hibf(bad)
        assert str(ours.value) == str(theirs.value), case
        assert tser.is_raptor_hibf(bad) == jser.is_raptor_hibf(bad), case


def test_export_raptor_hibf_matches_jax(tmp_path, genomes):
    """A forest exported as a 2-level archive: the port's file is the JAX
    export's, byte for byte, and both forests match."""
    hashes = genomes[1]
    forest = build_hibf(hashes, kmer_size=K, window_size=W, max_fp=0.05,
                        device="cpu")
    jforest = jax_build_hibf(hashes, kmer_size=K, window_size=W, max_fp=0.05)
    assert len(forest.subs) > 1
    ours, theirs = str(tmp_path / "p.hibf"), str(tmp_path / "j.hibf")
    export_raptor_hibf(forest, hashes, ours, device="cpu")
    jax_export(jforest, hashes, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


# --------------------------------------------------------------------------
# the flattened index and its counts


@pytest.mark.parametrize("name", sorted(LAYOUTS) + ["short-b2f"])
def test_raptor_hibf_matches_jax(layouts, name):
    r, j = RaptorHIBF.load(layouts[name]), JaxRaptorHIBF.load(layouts[name])
    assert r.hashes_count == j.hashes_count
    assert r.targets() == j.targets() and r.target_fpr() == j.target_fpr()
    assert r.ibf_config.to_dict() == j.ibf_config.to_dict()
    assert r.hashes_count_is_estimate


def _hashes_batch(genomes, seed=2, n=96, w=W):
    codes = genomes[0]
    longest = max(len(g) for g in codes.values())
    pool = np.stack([np.resize(g, longest) for g in codes.values()])
    batch = _batch(np.random.default_rng(seed), pool[:, :1500], n, True, w)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, n)
    h, nh, _ = tdev.extract_hashes(torch.from_numpy(inbuf), k=K, w=w, L1=L1,
                                   L2=L2)
    return h, nh


@pytest.mark.parametrize("name", sorted(LAYOUTS) + ["short-b2f"])
def test_device_raptor_counts_match_jax(layouts, genomes, name):
    tf = tdev.load_device_filter(layouts[name], "cpu")
    assert isinstance(tf, tdev.DeviceRaptorHIBF)
    jf = jdev.DeviceRaptorHIBF(JaxRaptorHIBF.load(layouts[name]))
    assert len(tf.subs) == len(jf.subs)
    for s, js in zip(tf.subs, jf.subs):
        assert np.array_equal(s.cols.numpy(), js["cols"])
        assert (s.bin_size, s.hash_funs) == (js["bin_size"], js["hash_funs"])
    h, n = _hashes_batch(genomes)
    mask = jnp.asarray(np.arange(h.shape[1])[None, :] < n.numpy()[:, None])
    want = np.asarray(jf.counts(jnp.asarray(h.numpy().view(np.uint64)), mask,
                                jnp.asarray(n.numpy())))
    got = tf.counts(h, n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.max() > 0


def test_layouts_cover_their_cases(layouts):
    """The hand layouts hold what their names say."""
    def parsed(name):
        return tser.read_raptor_hibf(layouts[name])

    p = parsed("root-users-and-merged")
    root = p["bin_to_filename"][0]
    assert (root >= 0).any() and (root < 0).any()
    # a user bin split over several technical bins
    assert max(np.bincount(b[b >= 0]).max() for b in p["bin_to_filename"]) > 1
    assert len({h for *_, h in p["ibfs"]}) > 1
    assert (parsed("merged-only-root")["bin_to_filename"][0] < 0).all()
    two = parsed("user-bin-in-two-ibfs")["bin_to_filename"]
    assert set(two[0][two[0] >= 0]) & set(two[1][two[1] >= 0])
    routing = parsed("routing-only-ibf")["bin_to_filename"]
    assert (routing[1] < 0).all() and len(routing) == 4
    short = parsed("short-b2f")
    assert all(len(b) < bits.shape[1] * 32 for b, (bits, *_) in
               zip(short["bin_to_filename"], short["ibfs"]))


@pytest.mark.parametrize("top_k,emit,cuts", [
    (4, True, (0.25, 0.1)),
    (16, False, (0.05, 1.0)),
    (128, True, (0.5, 0.0)),
])
def test_classify_batch_packed_raptor_matches_jax(layouts, genomes, top_k,
                                                  emit, cuts):
    path = layouts["user-bin-in-two-ibfs"]
    tf = tdev.load_device_filter(path, "cpu")
    jf = jdev.DeviceRaptorHIBF(JaxRaptorHIBF.load(path))
    codes = genomes[0]
    longest = max(len(g) for g in codes.values())
    pool = np.stack([np.resize(g, longest) for g in codes.values()])
    batch = _batch(np.random.default_rng(top_k), pool[:, :1500], 200, True, W)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 256)
    T = tf.num_targets
    kk = min(top_k, T)
    want = np.asarray(jdev.classify_batch_packed_raptor(
        tuple(s["tbl8"] for s in jf.subs),
        tuple(s["byte_starts"] for s in jf.subs),
        tuple(s["byte_ends"] for s in jf.subs),
        tuple(jnp.asarray(s["cols"]) for s in jf.subs), jnp.asarray(inbuf),
        cuts[0], cuts[1], 65535, k=K, w=W, L1=L1, L2=L2,
        sub_params=tuple((s["bin_size"], s["hash_funs"]) for s in jf.subs),
        num_targets=T, top_k=kk, pack16=True, match_cap=0,
        emit_matches_t=emit,
    ))
    got = tdev.classify_batch_packed(
        tf, torch.from_numpy(inbuf), cuts[0], cuts[1], 65535, k=K, w=W,
        L1=L1, L2=L2, top_k=kk, emit_matches_t=emit)
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result(got.numpy(), 256, kk, T,
                                   has_matches_t=emit)
    assert (res["n_matches"] > 0).sum() > 50


# --------------------------------------------------------------------------
# the engine and the CLI


@pytest.fixture(scope="module")
def reads(tmp_path_factory, genomes):
    tmp = tmp_path_factory.mktemp("raptor_reads")
    pools = {t: "".join("ACGT"[c] for c in g) for t, g in genomes[0].items()}
    r1, r2 = _reads(random.Random(8), pools, 160, W)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    return [str(tmp / "r1.fq"), str(tmp / "r2.fq")]


@pytest.fixture(scope="module")
def cereal_db(tmp_path_factory, flat_ibf):
    path = str(tmp_path_factory.mktemp("cereal") / "ref.ibf")
    tser.write_ibf(flat_ibf, path)
    return path


@pytest.mark.parametrize("name,thresholding", [
    ("root-users-and-merged", True),
    ("user-bin-in-two-ibfs", True),
    ("routing-only-ibf", False),
], ids=["fast", "two-ibfs-fast", "device-thresholding-off"])
def test_raptor_level_matches_jax(tmp_path, monkeypatch, layouts, reads,
                                  name, thresholding):
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[layouts[name]], paired_reads=reads,
        rel_cutoff=[0.5], rel_filter=[0.1], fpr_query=[1e-5],
        device_thresholding=thresholding, output_all=True,
        output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".all")
    assert (calls["fallback"] == 0) == thresholding


def test_raptor_compaction_overflow_matches_jax(tmp_path, monkeypatch):
    """k = 19, w = 20 emits densely: reads overflow the compaction width
    and the raptor level takes the uncompacted exact path."""
    codes, hashes = _genomes(seed=5, w=20)
    path = str(tmp_path / "dense.hibf")
    _write_layout(path, hashes, "root-users-and-merged", w=20)
    pools = {t: "".join("ACGT"[c] for c in g) for t, g in codes.items()}
    r1, r2 = _reads(random.Random(3), pools, 60, 20)
    write_fastq(tmp_path / "r1.fq", r1)
    write_fastq(tmp_path / "r2.fq", r2)
    _, calls = run_both(
        tmp_path, monkeypatch, ibf=[path],
        paired_reads=[str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")],
        rel_cutoff=[0.3], rel_filter=[0.2], fpr_query=[1.0],
        output_all=True, output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1


def test_cereal_ibf_level_matches_jax(tmp_path, monkeypatch, cereal_db,
                                      reads):
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[cereal_db], paired_reads=reads,
        rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5],
        output_all=True, output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".all") and calls["fallback"] == 0


def test_raptor_then_cereal_hierarchy_matches_jax(tmp_path, monkeypatch,
                                                  layouts, cereal_db, reads):
    port, calls = run_both(
        tmp_path, monkeypatch,
        ibf=[layouts["root-users-and-merged"], cereal_db],
        hierarchy_labels=["1_raptor", "2_cereal"], paired_reads=reads,
        rel_cutoff=[0.9, 0.4], rel_filter=[0.1], fpr_query=[1e-5],
        output_all=True, output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".1_raptor.all") and read_tsv(port + ".2_cereal.all")
    assert calls["fallback"] == 0


def test_raptor_beside_flat_on_one_level_matches_jax(tmp_path, monkeypatch,
                                                     layouts, cereal_db,
                                                     reads):
    """A level mixing a raptor archive with a flat filter has no fast
    path: every batch takes the exact host union path, as in JAX."""
    _, calls = run_both(
        tmp_path, monkeypatch,
        ibf=[layouts["user-bin-in-two-ibfs"], cereal_db], paired_reads=reads,
        rel_cutoff=[0.5, 0.3], rel_filter=[0.2], fpr_query=[1e-3],
        output_all=True, output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1


@pytest.mark.parametrize("fmt", ["raptor", "cereal"])
def test_cli_classifies_reference_databases(tmp_path, monkeypatch, layouts,
                                            cereal_db, reads, fmt):
    """``ganon_tpu_torch.cli classify --db-prefix`` finds a raptor
    ``.hibf`` or a cereal ``.ibf`` and writes the JAX engine's files (the
    CLI's config is moved to the CPU here: the CLI runs on CUDA)."""
    from ganon_tpu_torch import cli

    src = layouts["root-users-and-merged"] if fmt == "raptor" else cereal_db
    ext = ".hibf" if fmt == "raptor" else ".ibf"
    prefix = str(tmp_path / "db")
    with open(src, "rb") as f, open(prefix + ext, "wb") as g:
        g.write(f.read())
    seen = []

    def on_cpu(cfg, _run=port_engine.run_classify):
        seen.append(cfg.ibf)
        cfg.device = "cpu"
        return _run(cfg)

    monkeypatch.setattr(port_engine, "run_classify", on_cpu)
    out = str(tmp_path / "cli")
    cli.main("classify", db_prefix=[prefix], paired_reads=reads,
             output_prefix=out, output_all=True, output_unclassified=True,
             multiple_matches="skip", skip_report=True, quiet=True)
    assert seen == [[prefix + ext]]
    ref = str(tmp_path / "ref")
    jax_engine.run_classify(jax_engine.ClassifyConfig(
        ibf=[prefix + ext], paired_reads=reads, output_prefix=ref,
        output_all=True, output_unclassified=True, use_mesh=False))
    for e in (".all", ".unc", ".rep"):
        assert sorted(read_tsv(out + e)) == sorted(read_tsv(ref + e)), e
    assert read_tsv(out + ".all")
