"""The generators repeat for a seed, and the reference agrees with
``ganon_tpu_torch`` (run with ``device="cpu"``) at tiny sizes. The test
imports both; the reference itself imports neither the port nor JAX."""

import numpy as np
import pytest
import torch

from portbench.gen.genomes import make_genomes
from portbench.gen.reads import _fastq, make_sample
from portbench.harness import roofline, spec
from portbench.reference import ganon_ref as ref
from portbench.reference import pruned_ref, sizing_ref

SPEC = spec.load_json(spec.ROOT + "/portbench/configs/arc_cg_ibf.json")
GENOMES = dict(SPEC["genomes"], length={"dist": "uniform", "min": 20000,
                                        "max": 60000})


def _genomes(seed=7, species=3):
    return make_genomes(GENOMES, seed, "cpu", species=species)


def test_generators_repeat_for_a_seed():
    a, b, c = _genomes(11), _genomes(11), _genomes(12)
    assert torch.equal(a.codes, b.codes)
    assert not torch.equal(a.codes[:1000], c.codes[:1000])
    # a subset holds the same bases as the whole
    sub = make_genomes(GENOMES, 11, "cpu", species=2)
    assert torch.equal(sub.codes, a.codes[:sub.codes.numel()])
    m = spec.load_json(f"{spec.BENCH_DIR}/traffic/illumina_pairs.json")
    s1 = make_sample(a, m, 5, 0, "cpu", 500)
    s2 = make_sample(a, m, 5, 0, "cpu", 500)
    s3 = make_sample(a, m, 5, 1, "cpu", 500)
    for c in ("codes1", "codes2"):
        assert _fastq(s1.ids, getattr(s1, c)) == _fastq(s2.ids, getattr(s2, c))
        assert _fastq(s1.ids, getattr(s1, c)) != _fastq(s3.ids, getattr(s3, c))


def test_minimizers_agree_with_the_port():
    from ganon_tpu_torch.ops.winnow import minimizers_masked

    g = _genomes()
    gen = torch.Generator().manual_seed(3)
    lens = torch.randint(20, 400, (64,), generator=gen)
    codes = torch.randint(0, 4, (64, 400), generator=gen, dtype=torch.uint8)
    codes[:8, :300] = g.codes[:2400].view(8, 300)
    val, emit, n = minimizers_masked(codes, lens.to(torch.int32), k=19, w=31)
    got, rows = ref.read_hashes(codes, lens, 19, 31)
    assert torch.equal(torch.bincount(rows, minlength=64).to(torch.int32), n)
    assert torch.equal(got, val[emit])


def test_target_hashes_rows_and_matrix_agree_with_the_port():
    from ganon_tpu_torch.index.builder import _HashExtractor
    from ganon_tpu_torch.index.ibf import build_ibf
    from ganon_tpu_torch.ops.ibf_query import ibf_row_indices_np

    g = _genomes()
    ex = _HashExtractor(19, 31, device="cpu")
    host = g.codes.numpy()
    for t, name in enumerate(g.names):
        ex.add_encoded(name, host[g.offsets[t]:g.offsets[t + 1]])
    th = ex.finish()
    mine = [ref.distinct_hashes(g.target(t), 19, 31, piece=5000)
            for t in range(len(g.names))]
    for t, name in enumerate(g.names):
        assert np.array_equal(mine[t].numpy().view(np.uint64), th[name])
    rows = ibf_row_indices_np(th[g.names[0]], bin_size=12345,
                              hash_functions=3)
    for i in range(3):
        assert np.array_equal(ref.hash_rows(mine[0], 12345, i).numpy(),
                              rows[:, i])
    f = SPEC["filter"]
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=f["max_fp"],
                    mode=f["mode"], hash_functions=f["hash_functions"],
                    tpu_sizing=True, device="cpu")
    header = ibf._header()
    layout = ref.Layout.from_config(list(th), [int(mine[g.names.index(t)]
                                                   .numel()) for t in th], f)
    assert not any(layout.header_mismatch(header, ibf.bits.shape).values())
    want = ref.build_matrix([mine[g.names.index(t)] for t in th], layout,
                            "cpu")
    assert torch.equal(want, torch.from_numpy(ibf.bits.astype(np.int64)))
    fpr = ibf.target_fpr()
    assert np.allclose(layout.fpr, [fpr[t] for t in layout.targets],
                       rtol=1e-12)


@pytest.mark.parametrize("case", range(6))
def test_sizing_agrees_with_the_port(case):
    """The reference's sizing (ganon's search, then the --tpu-sizing auto
    re-size) gives the port's bin size, hash functions and bins."""
    from ganon_tpu_torch.index import sizing

    rng = np.random.default_rng(case)
    counts = rng.integers(1, int(10 ** (2 + case)), size=40 * (case + 1))
    fp = (0.05, 0.001, 0.01, 0.3, 0.05, 0.05)[case]
    mode = ("avg", "smaller", "faster", "smallest", "fastest", "avg")[case]
    for h, tune in ((0, True), (4, True), (0, False), (3, False)):
        c = sizing.size_filter({f"t{i}": int(x) for i, x in enumerate(counts)},
                               kmer_size=19, window_size=31, max_fp=fp,
                               hash_functions=h, mode=mode, tpu_sizing=tune)
        s = sizing_ref.size_filter([int(x) for x in counts], max_fp=fp,
                                   mode=mode, hash_functions=h, tune=tune)
        assert (s.bin_size, s.h, s.max_hashes_bin, s.n_bins, s.max_fp) == \
            (c.bin_size_bits, c.hash_functions, c.max_hashes_bin, c.n_bins,
             c.max_fp)


def test_pruned_tables_agree_with_the_port(tmp_path):
    """The reference's pruned layout and tables, from the configuration's
    settings, equal the port's ``build_pruned`` at a tiny size."""
    from ganon_tpu_torch.index.pruned import build_pruned

    f = dict(spec.load_json(spec.ROOT + "/portbench/configs/"
                            "viral_cg_hibf.json")["filter"], group_size=8)
    g = _genomes(species=6)
    mine = {n: ref.distinct_hashes(g.target(t), 19, 31, piece=5000)
            for t, n in enumerate(g.names)}
    pf = build_pruned({n: h.numpy().view(np.uint64) for n, h in mine.items()},
                      kmer_size=19, window_size=31, max_fp=f["max_fp"],
                      fine_h=f["fine_h"], coarse_fp=f["coarse_fp"],
                      coarse_h=f["coarse_h"], group_size=8, device=False)
    order = pf._targets
    lay = pruned_ref.PrunedLayout(order, [mine[n].numel() for n in order], f)
    pf.save_raw(str(tmp_path / "db.hibf"))
    header, got_fine, got_coarse = pruned_ref.read_pruned(
        str(tmp_path / "db.hibf"))
    assert not any(lay.header_mismatch(header).values())
    fine, coarse = pruned_ref.build_tables([mine[n] for n in order], lay,
                                           "cpu")
    assert pruned_ref.bytes_mismatch(got_fine, fine) == 0
    assert pruned_ref.bytes_mismatch(got_coarse, coarse) == 0


def test_count_bytes_on_a_hand_made_case(monkeypatch):
    """Two targets of 3 and 10 bins: a row of whole bytes a target is
    1 + 2 bytes. One read a batch: each read's distinct rows over both
    hash functions, times 3 bytes."""
    layout = ref.Layout(["a", "b"], [25, 100], bin_size=1000, h=2,
                        max_hashes_bin=10, k=19, w=31)
    assert (layout.bin_hi[0] - layout.bin_lo[0],
            layout.bin_hi[1] - layout.bin_lo[1]) == (3, 10)
    assert roofline.table_row_bytes(layout) == 3

    class Two:
        gen = torch.Generator().manual_seed(9)
        codes1 = torch.randint(0, 4, (2, 200), generator=gen,
                               dtype=torch.uint8)
        codes2 = torch.randint(0, 4, (2, 200), generator=gen,
                               dtype=torch.uint8)
        len1 = torch.tensor([200, 120])
        len2 = torch.tensor([90, 200])
        ids = ["x", "y"]

        def __len__(self):
            return 2

    monkeypatch.setattr(roofline, "BATCH_READS", 1)
    want = 0
    for r in range(2):
        rows = set()
        for c, ln in ((Two.codes1, Two.len1), (Two.codes2, Two.len2)):
            hs, _ = ref.read_hashes(c[r:r + 1], ln[r:r + 1], 19, 31)
            rows |= {int(x) for i in range(2)
                     for x in ref.hash_rows(hs, 1000, i)}
        want += len(rows) * 3
    assert roofline.count_bytes(Two(), layout, "cpu") == want


def test_trace_reduction_and_kernel_time():
    """Busy time is the union of device activity, kernel time the sum of
    the kernel records alone; a gap is named by the innermost span open
    at its middle; a kernel's time comes from the trace when it holds
    every launch, and is absent otherwise."""
    from types import SimpleNamespace

    from portbench.harness import kernel_time
    from portbench.harness.trace import reduce_trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "span.sample",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "span.reassign",
         "ts": 400, "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "void count_kernel<8>(int)",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void count_kernel<8>(int)",
         "ts": 120, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 300, "dur": 10},
    ]
    r = reduce_trace(ev)
    assert abs(r["busy_s"] - 80e-6) < 1e-12
    assert abs(r["kernel_s"] - 100e-6) < 1e-12 and r["kernel_n"] == 2
    assert r["idle_gaps"][0] == ["reassign", 690e-6]
    assert r["ops"]["void count_kernel<8>(int)"] == (100e-6, 2)
    run = SimpleNamespace(ops=r["ops"], launches={"count": 2}, sources={})
    assert kernel_time.seconds(run, "count", "count_kernel") == 100e-6
    assert run.sources["count"] == "trace: 2 records for 2 launches"
    run.launches = {"count": 3}  # a record lost: no reading, no fallback
    assert kernel_time.seconds(run, "count", "count_kernel") is None
    assert run.sources["count"] == "trace: 2 records for 3 launches"
    assert kernel_time.seconds(run, "gate", "gate_kernel") is None
