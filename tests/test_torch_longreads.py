"""Long reads and wide filters: the port's 32-bit counter layout against
``ganon_tpu``.

``select``'s 32-bit mode (plain version on the CPU) returns the int32
buffer of ``ganon_tpu.classify.device.threshold_topk(sort16=False)`` +
``_pack_result(pack16=False)`` exactly at T = 70,000, with counts above
0xFFFF, ties across ids on both sides of 0xFFFF, reads without hashes,
reads over the hashes limit and K above the read's matches; the packed
flat batch (``classify_batch_packed(pack16=False)``) equals JAX's; and
``run_classify`` with ``hashes_limit = 2^32 - 1`` (``--longreads``) on
mixed-length single-end reads writes the JAX engine's files (sorted
rows, ``.sta`` byte for byte) for a flat filter, a native forest, a
raptor archive, a pruned forest (the exact path) and a level of two flat
filters (the exact path), as does a read of more than 65,535 minimizers
(skipped as big without the flag) and a flat filter of more than 65,535
targets on the fast path. All exact: counts are integers (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu.index.pruned import build_pruned as jax_build_pruned
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.builder import _HashExtractor
from raptor_layout import write_raptor_layout
from tests.test_classify import read_tsv, write_fastq, write_tax
from tests.test_torch_engine import run_both

K, W = 19, 31
LONG = (1 << 32) - 1  # --longreads


def _jax_limit(limit):
    """The limit as the JAX functions must receive it: a jitted function
    takes a Python int as a weakly typed scalar, which ``n_hashes <=
    limit`` then casts to the int32 of ``n_hashes``, so 2^32 - 1 turns
    into -1 and every read fails the limit. A strong int64 keeps it."""
    return np.int64(limit)


def _hashes(genomes: dict, k=K, w=W):
    ex = _HashExtractor(k, w, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    return ex.finish()


def _seq(codes):
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode()


# --------------------------------------------------------------------------
# select in its 32-bit mode


def _wide_counts(seed, B=7, T=70_000):
    """Counts above 0xFFFF with ties across ids on both sides of 0xFFFF;
    row 5 has no hashes, row 6 more than 100,000 (over the small limit)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(70_000, 99_000, size=B).astype(np.int32)
    n[5], n[6] = 0, 150_000
    counts = np.zeros((B, T), np.int32)
    for b in range(B):
        hot = rng.choice(T, size=24, replace=False)
        counts[b, hot] = rng.integers(int(n[b]) // 3, int(n[b]) + 1, size=24)
        top = int(n[b]) - int(rng.integers(0, 50))
        for t in (7, 0xFFFF - 1, 0xFFFF, 0xFFFF + 1, T - 1):
            counts[b, t] = top  # equal keys but for the id
    counts[1, :] = int(n[1]) // 2  # every target final, all tied
    return counts, n, (rng.random(B) < 0.3).astype(np.uint8)


@pytest.mark.parametrize("cuts", [(0.75, 0.1, LONG), (0.25, 1.0, LONG),
                                  (0.0, 0.0, 100_000)],
                         ids=["defaults", "rel-filter-1", "limit-100k"])
@pytest.mark.parametrize("top_k,emit", [(4, True), (128, False)])
def test_select32_matches_jax(cuts, top_k, emit):
    counts, n, ovf = _wide_counts(sum(map(int, cuts[:2])) + top_k)
    res = jdev.threshold_topk(jnp.asarray(counts), jnp.asarray(n), *cuts[:2],
                              _jax_limit(cuts[2]), top_k=top_k, sort16=False,
                              emit_matches_t=emit)
    want = np.asarray(jdev._pack_result(
        res, jnp.asarray(n), jnp.asarray(ovf.astype(bool)), pack16=False,
        match_cap=0))
    got = tdev.select(torch.from_numpy(counts), torch.from_numpy(n),
                      torch.from_numpy(ovf), *cuts, top_k=top_k,
                      emit_matches_t=emit, pack16=False)
    assert np.array_equal(got.numpy(), want)
    B, T = counts.shape
    un = tdev.unpack_batch_result(got.numpy(), B, min(top_k, T), T,
                                  has_matches_t=emit, pack16=False)
    assert (un["top_vals"] > 0xFFFF).any()
    assert (un["n_matches"] < min(top_k, T)).any()  # K above the matches


def test_select_refuses_16_bit_layout_past_its_bounds():
    c = torch.zeros((2, 0x10000), dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    o = torch.zeros(2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="0xFFFF"):
        tdev.select(c, n, o, 0.5, 0.0, 65535, top_k=4)
    with pytest.raises(ValueError, match="0xFFFF"):
        tdev.select(c[:, :10], n, o, 0.5, 0.0, LONG, top_k=4)
    with pytest.raises(ValueError, match="winners"):
        tdev.select(c[:, :10], n, o, 0.5, 0.0, LONG, top_k=4,
                    uwin=torch.zeros((2, 10), dtype=torch.int32),
                    pack16=False)


# --------------------------------------------------------------------------
# genomes, reads and databases


def _genomes(seed=61):
    """Ten targets of skewed lengths (the forest stratifies them); the
    first four share a 3 kbp core, so core reads tie across them."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=3000, dtype=np.uint8)
    lens = (4000, 5000, 7000, 9000, 3000, 12000, 18000, 26000, 36000, 48000)
    out = {}
    for i, n in enumerate(lens):
        g = rng.integers(0, 4, size=n, dtype=np.uint8)
        out[f"L{i}"] = np.concatenate([core, g]) if i < 4 else g
    return out


def _long_reads(rng, genomes, n, classes=(500, 2000, 8000)):
    """Single-end reads of mixed lengths (a third reverse-complemented),
    core reads tying four targets, junk and reads shorter than w."""
    names = sorted(genomes)
    reads = {}
    for i in range(n):
        t = names[int(rng.integers(len(names)))]
        g = genomes[t]
        ln = min(int(rng.choice(classes)), len(g))
        s = int(rng.integers(0, len(g) - ln + 1))
        codes = g[s:s + ln]
        if i % 3 == 0:
            codes = 3 - codes[::-1]
        reads[f"q{i}|{t}"] = _seq(codes)
    core = genomes["L0"][:3000]
    for i, s in enumerate(range(0, 2000, 400)):
        reads[f"core{i}"] = _seq(core[s:s + 1000])
    for i in range(4):
        reads[f"junk{i}"] = _seq(rng.integers(0, 4, size=2000,
                                              dtype=np.uint8))
    reads["short0"] = _seq(genomes["L5"][100:120])
    return reads


def _tax(path, names):
    rows = [("1", "0", "no rank", "root"), ("G0", "1", "genus", "G0"),
            ("G1", "1", "genus", "G1")]
    rows += [(t, f"G{i % 2}", "species", t) for i, t in enumerate(names)]
    return write_tax(path, rows)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("longreads")
    genomes = _genomes()
    names = sorted(genomes)
    hashes = _hashes(genomes)
    out = {"tax": _tax(tmp / "all.tax", names)}
    kw = dict(kmer_size=K, window_size=W, max_fp=0.05)
    out["flat"] = str(tmp / "flat.ibf")
    jax_build_ibf(hashes, **kw).save(out["flat"])
    forest = jax_build_hibf(hashes, **kw)
    assert len(forest.subs) > 1
    out["forest"] = str(tmp / "forest.hibf")
    forest.save(out["forest"])
    out["raptor"] = str(tmp / "raptor.hibf")
    write_raptor_layout(hashes, [(names[6:], [1, 2]), (names[:3], []),
                                 (names[3:6], [])], out["raptor"],
                        device="cpu", **kw)
    out["pruned"] = str(tmp / "pruned.hibf")
    jax_build_pruned(hashes, group_size=8, **kw).save(out["pruned"])
    for key, part in (("flat_a", names[:6]), ("flat_b", names[4:])):
        out[key] = str(tmp / f"{key}.ibf")
        jax_build_ibf({t: hashes[t] for t in part}, **kw).save(out[key])
    write_fastq(tmp / "r.fq", _long_reads(np.random.default_rng(3),
                                          genomes, 90))
    out["reads"] = [str(tmp / "r.fq")]
    return out


@pytest.mark.parametrize("emit", [True, False], ids=["fpr-off", "fpr-on"])
def test_classify_batch_packed_32bit_matches_jax(dbs, emit):
    """The flat batch at long-read widths, ``pack16=False``: JAX's
    buffer exactly."""
    from ganon_tpu.index.ibf import IBF as JaxIBF

    genomes = _genomes()
    rng = np.random.default_rng(9)
    reads = list(_long_reads(rng, genomes, 40, classes=(2000,)).values())
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = np.frombuffer(
            r.translate(str.maketrans("ACGT", "\0\1\2\3")).encode(), np.uint8)
        lens[i] = len(r)
    from ganon_tpu_torch.io.pipeline import EncodedBatch

    batch = EncodedBatch(prefix="", paired=False,
                         ids=[str(i) for i in range(len(reads))],
                         codes1=codes, len1=lens,
                         codes2=np.zeros((len(reads), 0), np.uint8),
                         len2=np.zeros(len(reads), np.int32))
    inbuf, L1, L2 = tdev.pack_batch_direct(batch, 64)
    ibf = JaxIBF.load(dbs["flat"])
    jf = jdev.DeviceFilter(ibf)
    want = np.asarray(jdev.classify_batch_packed(
        jf.tbl8, jf.byte_starts, jf.byte_ends, jnp.asarray(inbuf), 0.75,
        0.1, _jax_limit(LONG), k=K, w=W, L1=L1, L2=L2,
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions, top_k=8,
        pack16=False, emit_matches_t=emit))
    tf = tdev.load_device_filter(dbs["flat"], "cpu")
    got = tdev.classify_batch_packed(
        tf, torch.from_numpy(inbuf), 0.75, 0.1, LONG, k=K, w=W, L1=L1,
        L2=L2, top_k=8, emit_matches_t=emit, pack16=False)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["flat", "forest", "raptor", "pruned",
                                  "two-filters"])
def test_longreads_engine_matches_jax(tmp_path, monkeypatch, dbs, kind):
    """``hashes_limit = 2^32 - 1``: flat, forest and raptor take the fast
    path in the 32-bit layout; a pruned forest and a level of several
    filters take the exact path on every batch, as in the JAX engine."""
    ibf = ([dbs["flat_a"], dbs["flat_b"]] if kind == "two-filters"
           else [dbs[kind]])
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=ibf, tax=[dbs["tax"]] * len(ibf),
        single_reads=dbs["reads"], hashes_limit=LONG,
        jax_kw={"hashes_limit": _jax_limit(LONG)}, rel_cutoff=[0.75],
        rel_filter=[0.1], fpr_query=[1e-5], output_lca=True,
        output_all=True, output_unclassified=True, output_stats=True)
    listed = {}
    for rid, t, _ in read_tsv(port + ".all"):
        listed.setdefault(rid, set()).add(t)
    sampled = [r for r in listed if "|" in r]
    assert sampled and all(r.split("|")[1] in listed[r] for r in sampled)
    assert len(listed.get("core0", ())) == 4  # a tie across four targets
    if kind in ("pruned", "two-filters"):
        assert calls["fallback"] == calls["dispatch"] >= 1
    else:
        assert calls["fallback"] == 0


@pytest.fixture(scope="module")
def dense_db(tmp_path_factory):
    """k = w = 15 emits almost every position: one 70 kbp read carries
    more than 65,535 minimizers (and overflows the compaction width)."""
    tmp = tmp_path_factory.mktemp("dense")
    rng = np.random.default_rng(17)
    genomes = {f"D{i}": rng.integers(0, 4, size=n, dtype=np.uint8)
               for i, n in enumerate((90_000, 6000, 8000))}
    hashes = _hashes(genomes, k=15, w=15)
    db = str(tmp / "dense.ibf")
    jax_build_ibf(hashes, kmer_size=15, window_size=15,
                  max_fp=0.05).save(db)
    reads = {"big|D0": _seq(genomes["D0"][5000:75_000])}
    for i in range(6):
        t = f"D{1 + i % 2}"
        reads[f"s{i}|{t}"] = _seq(genomes[t][i * 500:i * 500 + 1500])
    write_fastq(tmp / "r.fq", reads)
    return db, str(tmp / "r.fq")


@pytest.mark.parametrize("limit", [LONG, 65535], ids=["longreads", "default"])
def test_read_over_u16_minimizers_matches_jax(tmp_path, monkeypatch,
                                              dense_db, limit):
    db, reads = dense_db
    port, _ = run_both(
        tmp_path, monkeypatch, ibf=[db], single_reads=[reads],
        hashes_limit=limit, jax_kw={"hashes_limit": _jax_limit(limit)},
        rel_cutoff=[0.75], rel_filter=[0.1],
        fpr_query=[1.0], output_all=True, output_unclassified=True,
        output_stats=True)
    rows = read_tsv(port + ".all")
    big = [r for r in rows if r[0] == "big|D0"]
    if limit == LONG:
        assert [r[1] for r in big] == ["D0"] and int(big[0][2]) > 0xFFFF
    else:  # skipped as big: not processed, not classified
        assert not big
        sta = read_tsv(port + ".sta")
        assert sta[1][2] == "6"  # seq_processed: the six short reads
    assert {r[0] for r in rows} >= {f"s{i}|D{1 + i % 2}" for i in range(6)}


def test_reader_width_returns_after_an_ultra_long_read(tmp_path):
    """The port's native reader grows its row width for a 300 kbp read
    and shrinks it back to the longest read of the batch it has just
    read (the JAX package's reader keeps the grown width to the end of
    the file); every record comes back whole and in order."""
    from ganon_tpu_torch.native import NativeSeqReader

    rng = np.random.default_rng(4)
    recs = {f"a{i}": _seq(rng.integers(0, 4, size=150)) for i in range(5)}
    recs["ultra"] = _seq(rng.integers(0, 4, size=300_000))
    recs |= {f"b{i}": _seq(rng.integers(0, 4, size=150)) for i in range(300)}
    write_fastq(tmp_path / "r.fq", recs)
    r = NativeSeqReader(str(tmp_path / "r.fq"))
    got, widths = [], []
    while True:
        ids, codes, lengths = r.next_batch_adaptive(100, row_budget=1 << 22)
        if not ids:
            break
        widths.append(codes.shape[1])
        got += [(rid, _seq(codes[i, :lengths[i]]))
                for i, rid in enumerate(ids)]
    assert got == list(recs.items())
    # the batch that holds the long read and the one after it
    assert max(widths) == 1 << 19 and widths[-1] == 256
    assert sum(w == 1 << 19 for w in widths) == 2


@pytest.fixture(scope="module")
def wide_db(tmp_path_factory):
    """70,000 tiny dummy targets (20 synthetic hashes each) and six real
    genomes, whose ids land above 0xFFFF."""
    tmp = tmp_path_factory.mktemp("wide")
    rng = np.random.default_rng(23)
    base = np.arange(70_000, dtype=np.uint64) * np.uint64(1 << 33)
    th = {f"D{i}": base[i] + np.arange(20, dtype=np.uint64)
          for i in range(70_000)}
    real = {f"R{t}": rng.integers(0, 4, size=900, dtype=np.uint8)
            for t in range(6)}
    th.update(_hashes(real))
    ibf = jax_build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05)
    targets = ibf.targets()
    assert all(targets.index(t) > 0xFFFF for t in real)
    db = str(tmp / "wide.ibf")
    ibf.save(db)
    reads = {}
    for i in range(40):
        t = f"R{int(rng.integers(6))}"
        s = int(rng.integers(0, 900 - 300))
        reads[f"w{i}|{t}"] = _seq(real[t][s:s + 300])
    write_fastq(tmp / "r.fq", reads)
    return db, str(tmp / "r.fq")


def test_wide_flat_filter_fast_path_matches_jax(tmp_path, monkeypatch,
                                                wide_db):
    """More than 65,535 targets in one flat filter at the default hashes
    limit: the fast path in the 32-bit layout, no fallback."""
    db, reads = wide_db
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[db], single_reads=[reads],
        rel_cutoff=[0.5], rel_filter=[0.1], fpr_query=[1e-5],
        output_all=True, output_unclassified=True, output_stats=True)
    listed = {}
    for rid, t, _ in read_tsv(port + ".all"):
        listed.setdefault(rid, set()).add(t)
    assert len(listed) == 40
    assert all(rid.split("|")[1] in ts for rid, ts in listed.items())
    assert calls == {"dispatch": 1, "fallback": 0}
