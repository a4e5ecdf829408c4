"""Native HIBF forests: the port against ``ganon_tpu``.

The build (``build_hibf``) gives the same subs, bits, configs,
hashes_count and bin_map; each package loads the npz and raw ``.hibf``
files the other writes; ``classify_batch_packed_forest`` (extract once,
count each sub into its columns, select) returns the JAX function's int32
buffer exactly (``match_cap=0``); and a forest level classifies, alone or
in a hierarchy, to the JAX engine's outputs. Raptor ``.hibf`` files open
as the port's ``DeviceRaptorHIBF`` (tested in ``test_torch_raptor.py``),
pruned ones as its ``DevicePrunedForest`` (``test_torch_pruned.py``).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.hibf import HIBF as JaxHIBF
from ganon_tpu.index.hibf import build_hibf as jax_build_hibf
from ganon_tpu.index.hibf import export_raptor_hibf
from ganon_tpu.index.pruned import build_pruned
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.hibf import HIBF, build_hibf
from tests.test_classify import build_db, read_tsv, write_fastq
from tests.test_torch_device import _batch
from tests.test_torch_engine import run_both
from tests.test_torch_hierarchy import _reads
from tests.test_torch_index import _assert_same_ibf

# skewed genome lengths: the forest stratifies into several sub-IBFs
LENGTHS = (1500, 1700, 2500, 3000, 6000, 7000, 16000, 20000)


def _genomes(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return {f"F{i}": rng.integers(0, 4, size=n, dtype=np.uint8)
            for i, n in enumerate(lengths)}


def _hashes(genomes, k=19, w=31):
    ex = _HashExtractor(k, w, device="cpu")
    for t, g in genomes.items():
        ex.add_encoded(t, g)
    return ex.finish()


def _assert_same_forest(a, b):
    assert len(a.subs) == len(b.subs)
    for sa, sb in zip(a.subs, b.subs):
        _assert_same_ibf(sa, sb)
    assert a.ibf_config.to_dict() == b.ibf_config.to_dict()
    assert a.hashes_count == b.hashes_count
    assert a.targets() == b.targets()


@pytest.fixture(scope="module")
def forest():
    genomes = _genomes(31)
    jhibf = jax_build_hibf(_hashes(genomes), kmer_size=19, window_size=31,
                           max_fp=0.05)
    assert len(jhibf.subs) > 1
    return genomes, jhibf


@pytest.mark.parametrize("kw", [
    dict(max_fp=0.05),
    dict(max_fp=0.01, hash_functions=3, tpu_sizing=False, num_classes=3),
], ids=["auto-h", "h3-three-classes"])
def test_build_hibf_matches_jax(kw):
    hashes = _hashes(_genomes(5))
    want = jax_build_hibf(hashes, kmer_size=19, window_size=31, **kw)
    got = build_hibf(hashes, kmer_size=19, window_size=31, device="cpu",
                     **kw)
    assert len(want.subs) > 1
    _assert_same_forest(got, want)
    assert got.target_fpr() == want.target_fpr()


@pytest.mark.parametrize("raw", [False, True], ids=["npz", "raw"])
def test_hibf_files_cross_load(tmp_path, forest, raw):
    _, jhibf = forest
    a, b = str(tmp_path / "jax.hibf"), str(tmp_path / "port.hibf")
    (jhibf.save_raw if raw else jhibf.save)(a)
    port = HIBF.load(a)
    _assert_same_forest(port, jhibf)
    (port.save_raw if raw else port.save)(b)
    _assert_same_forest(JaxHIBF.load(b), jhibf)
    if raw:
        assert open(a, "rb").read() == open(b, "rb").read()


def test_load_device_filter_refuses_pruned_and_raptor(tmp_path, forest):
    """Each ``.hibf`` kind opens as its own device filter (none is refused
    since the raptor archive was ported): a raptor archive as a
    DeviceRaptorHIBF, a pruned forest as a DevicePrunedForest, a native
    forest as a DeviceHIBF."""
    genomes, jhibf = forest
    hashes = _hashes(genomes)
    pruned, raptor = str(tmp_path / "p.hibf"), str(tmp_path / "r.hibf")
    jp = build_pruned(hashes, kmer_size=19, window_size=31)
    jp.save(pruned)
    export_raptor_hibf(jhibf, hashes, raptor)
    fp = tdev.load_device_filter(pruned, "cpu")
    assert isinstance(fp, tdev.DevicePrunedForest)
    assert fp.targets == jp.targets() and fp.num_groups == jp.num_groups
    fr = tdev.load_device_filter(raptor, "cpu")
    assert isinstance(fr, tdev.DeviceRaptorHIBF)
    assert sorted(fr.targets) == sorted(jhibf.targets())
    # the exported root holds merged bins only: the subs are the classes
    assert len(fr.subs) == len(jhibf.subs)
    native = str(tmp_path / "n.hibf")
    jhibf.save(native)
    f = tdev.load_device_filter(native, "cpu")
    assert isinstance(f, tdev.DeviceHIBF) and f.contiguous
    assert f.targets == jhibf.targets() and len(f.subs) == len(jhibf.subs)


@pytest.mark.parametrize("top_k,emit,cuts", [
    (4, True, (0.25, 0.1)),
    (16, False, (0.05, 1.0)),
])
def test_classify_batch_packed_forest_matches_jax(tmp_path, forest, top_k,
                                                  emit, cuts):
    genomes, jhibf = forest
    k, w = 19, 31
    jf = jdev.DeviceHIBF(jhibf)
    path = str(tmp_path / "f.hibf")
    jhibf.save(path)
    tf = tdev.DeviceHIBF(HIBF.load(path), "cpu")
    longest = max(len(g) for g in genomes.values())
    pool = np.stack([np.resize(g, longest) for g in genomes.values()])
    rng = np.random.default_rng(top_k)
    batch = _batch(rng, pool[:, :1500], 200, True, w)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 256)
    T = tf.num_targets
    K = min(top_k, T)
    want = np.asarray(jdev.classify_batch_packed_forest(
        tuple(s.tbl8 for s in jf.subs), tuple(s.byte_starts for s in jf.subs),
        tuple(s.byte_ends for s in jf.subs), jnp.asarray(inbuf),
        cuts[0], cuts[1], 65535, k=k, w=w, L1=L1, L2=L2,
        sub_params=tuple((s.ibf_config.bin_size_bits,
                          s.ibf_config.hash_functions) for s in jf.subs),
        top_k=K, pack16=True, match_cap=0, emit_matches_t=emit,
    ))
    got = tdev.classify_batch_packed_forest(
        tf, torch.from_numpy(inbuf), cuts[0], cuts[1], 65535, k=k, w=w,
        L1=L1, L2=L2, top_k=K, emit_matches_t=emit,
    )
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result(got.numpy(), 256, K, T,
                                   has_matches_t=emit)
    # matches land in more than one sub's columns
    valid = np.arange(K)[None, :] < np.minimum(res["n_matches"], K)[:, None]
    hit_subs = {int(np.searchsorted(np.cumsum([len(c) for c in tf.sub_cols]),
                                    t, side="right"))
                for t in res["top_idx"][valid]}
    assert len(hit_subs) > 1


def test_forest_counts_write_each_sub_into_its_columns(forest):
    genomes, jhibf = forest
    tf = tdev.DeviceHIBF(HIBF(jhibf.subs, 19, 31, 0.05), "cpu")
    jf = jdev.DeviceHIBF(jhibf)
    rng = np.random.default_rng(2)
    batch = _batch(rng, np.stack([g[:1500] for g in genomes.values()]), 64,
                   False, 31)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 64)
    h, n, _ = tdev.extract_hashes(torch.from_numpy(inbuf), k=19, w=31,
                                  L1=L1, L2=L2)
    hj = jnp.asarray(h.numpy().view(np.uint64))
    mask = jnp.asarray(np.arange(h.shape[1])[None, :] < n.numpy()[:, None])
    want = np.asarray(jf.counts(hj, mask, jnp.asarray(n.numpy())))
    assert np.array_equal(tf.counts(h, n).numpy(), want)


@pytest.fixture(scope="module")
def forest_db(tmp_path_factory, forest):
    """The forest as ``host.hibf``, two flat databases (the second sharing
    a forest target's name with other content) and paired reads over all."""
    tmp = tmp_path_factory.mktemp("forestdb")
    genomes, jhibf = forest
    jhibf.save(str(tmp / "host.hibf"))
    rng = random.Random(8)

    def rand(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    refs1 = {f"R{i}": rand(1200) for i in range(4)}
    refs2 = {"R0": rand(1200), "F0": rand(1200), "S0": rand(1200)}
    db1 = build_db(tmp, refs1, name="refs1", k=19, w=31, max_fp=0.05)
    db2 = build_db(tmp, refs2, name="refs2", k=19, w=31, max_fp=0.01)
    pools = {t: "".join("ACGT"[c] for c in g) for t, g in genomes.items()}
    pools.update(refs1)
    pools.update({"R0b": refs2["R0"], "F0b": refs2["F0"], "S0": refs2["S0"]})
    r1, r2 = _reads(rng, pools, 150, 31)
    write_fastq(tmp / "r1.fq", r1)
    write_fastq(tmp / "r2.fq", r2)
    return dict(host=str(tmp / "host.hibf"), refs1=db1, refs2=db2,
                reads=[str(tmp / "r1.fq"), str(tmp / "r2.fq")])


@pytest.mark.parametrize("thresholding", [True, False],
                         ids=["forest-fast", "device-thresholding-off"])
def test_forest_level_matches_jax(tmp_path, monkeypatch, forest_db,
                                  thresholding):
    port, calls = run_both(
        tmp_path, monkeypatch, ibf=[forest_db["host"]],
        paired_reads=forest_db["reads"], rel_cutoff=[0.5], rel_filter=[0.1],
        fpr_query=[1e-5], device_thresholding=thresholding,
        output_all=True, output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".all")
    assert (calls["fallback"] == 0) == thresholding


def test_forest_then_two_databases_matches_jax(tmp_path, monkeypatch,
                                               forest_db):
    """The tentpole's shape: ``--db-prefix host refs1 refs2
    --hierarchy-labels 1_host 2_refs 2_refs`` at CLI-default thresholds."""
    port, calls = run_both(
        tmp_path, monkeypatch,
        ibf=[forest_db["host"], forest_db["refs1"], forest_db["refs2"]],
        hierarchy_labels=["1_host", "2_refs", "2_refs"],
        paired_reads=forest_db["reads"], rel_cutoff=[0.75],
        rel_filter=[0.1], fpr_query=[1e-5], output_all=True,
        output_unclassified=True, output_stats=True)
    assert read_tsv(port + ".1_host.all") and read_tsv(port + ".2_refs.all")
    assert calls["fallback"] == 0


def test_forest_and_flat_on_one_level_matches_jax(tmp_path, monkeypatch,
                                                  forest_db):
    """A level mixing a forest with a flat filter has no fast path: every
    batch takes the exact host union path, as in the JAX package."""
    _, calls = run_both(
        tmp_path, monkeypatch, ibf=[forest_db["host"], forest_db["refs2"]],
        paired_reads=forest_db["reads"], rel_cutoff=[0.5, 0.3],
        rel_filter=[0.2], fpr_query=[1e-3], output_all=True,
        output_unclassified=True, output_stats=True)
    assert calls["fallback"] >= 1
