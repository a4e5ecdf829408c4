"""Host helpers of the tiled extract kernel and the chained scans' status
words, on the CPU, and the build's extract callers without the zero tail
against the JAX package.

``ops.ibf_query.extract_tiles`` and ``extract_smem`` size the extract
kernel's grid and shared memory (``csrc/extract.cu``);
``kernels.scan_status`` hands ``ragged``, ``pairs`` and ``extract`` their
status words and epochs. The build's two extract callers pass
``zero_tail=False`` (they read only the first ``n`` slots of each row);
their results must still equal the JAX package's.
"""

import numpy as np
import pytest
import torch

from ganon_tpu.index.builder import sequence_hashes as jax_sequence_hashes
from ganon_tpu.index.device_build import DeviceBuildPipeline as JaxPipeline
from ganon_tpu.ops.minimizers import encode_seqs
from ganon_tpu_torch import kernels
from ganon_tpu_torch.index import builder as tbuilder
from ganon_tpu_torch.index import device_build as tdb
from ganon_tpu_torch.ops import ibf_query as q

K, W = 19, 31


@pytest.mark.parametrize("L1,L2,w,tiles", [
    (160, 160, 31, 2),          # a classify pair: one tile a mate
    (2048, 0, 31, 4),           # a build piece: 2018 windows
    (1 << 20, 0, 31, 2048),     # an ultra-long row
    (542, 0, 31, 1),            # exactly one tile of 512 windows
    (543, 0, 31, 2),            # one window past it
    (20, 0, 31, 1),             # no window: still one tile (n, overflow)
    (160, 20, 31, 1),           # mate 2 narrower than w: no tile of its own
    (64, 64, 19, 2),            # w == k
])
def test_extract_tiles(L1, L2, w, tiles):
    assert q.extract_tiles(L1, L2, w) == tiles


def test_extract_smem_fits_the_card():
    """10.6 KB a block at k 19, w 31; the guard's widest window still fits
    in 227 KB, one wider does not."""
    assert q.extract_smem(19, 31) == 8 * 525 + 8 * 512 + 8 * 19 + 2104
    ww = max(v for v in range(1, 40_000)
             if q.extract_smem(19, 19 + v - 1) + 512 <= q._SMEM_LIMIT)
    assert 18_000 < ww < 19_000
    assert q.extract_smem(19, 19 + ww) + 512 > q._SMEM_LIMIT


def test_scan_status_sizing_and_epochs(monkeypatch):
    """One buffer a (device, stream): at least 64 words, blocks + 1 for a
    larger grid, reused for a smaller one; a new epoch every call; when
    the epochs wrap every buffer is made anew (zero) and counting starts
    at 1 again."""
    monkeypatch.setattr(kernels, "_SCAN_STATUS", {})
    cpu = torch.device("cpu")
    buf, e1 = kernels.scan_status(cpu, 3)
    assert buf.numel() == kernels.SCAN_STATUS_MIN and buf.dtype == torch.int64
    assert not buf.any()
    buf2, e2 = kernels.scan_status(cpu, 1000)
    assert buf2.numel() == 1001 and e2 > e1
    buf2[0] = 7
    buf3, e3 = kernels.scan_status(cpu, 20)
    assert buf3 is buf2 and e3 > e2
    assert len(kernels._SCAN_STATUS) == 1
    monkeypatch.setattr(kernels, "_SCAN_EPOCHS",
                        iter(range(kernels.EPOCH_LIMIT - 1,
                                   kernels.EPOCH_LIMIT + 3)))
    _, e4 = kernels.scan_status(cpu, 20)
    assert e4 == kernels.EPOCH_LIMIT - 1
    buf5, e5 = kernels.scan_status(cpu, 20)
    assert e5 == 1 and buf5 is not buf2 and not buf5.any()


@pytest.mark.parametrize("k,w,L1,L2", [(19, 31, 160, 160), (19, 31, 2048, 0),
                                       (21, 21, 600, 0)])
def test_extract_zero_tail_keyword_on_cpu(k, w, L1, L2):
    """On the CPU the keyword changes nothing: the plain version, zeros
    past min(n, mc) included."""
    rng = np.random.default_rng(k + L1)
    row = L1 // 4 + L2 // 4 + 4 + (4 if L2 else 0)
    buf = rng.integers(0, 256, size=(24, row), dtype=np.uint8)
    lens = rng.integers(0, L1 + 1, size=(24, 2 if L2 else 1)).astype("<i4")
    buf[:, L1 // 4 + L2 // 4:] = lens.view(np.uint8).reshape(24, -1)
    inbuf = torch.from_numpy(buf)
    mc = 16
    want = q.extract_plain(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc)
    got = q.extract(inbuf, L1=L1, L2=L2, k=k, w=w, mc=mc, zero_tail=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(want[2].any())


def _spy_extract(monkeypatch, module):
    """Record the zero_tail of every extract call of ``module``."""
    seen = []

    def spy(*a, **kw):
        seen.append(kw.get("zero_tail", True))
        return q.extract(*a, **kw)

    monkeypatch.setattr(module, "extract", spy)
    return seen


def _random_seqs(rng, lens):
    return ["".join("ACGT"[b] for b in rng.integers(0, 4, size=n))
            for n in lens]


def test_hash_extractor_skips_the_zero_tail(monkeypatch):
    """The library build's extractor asks for no zero tail and still gives
    the JAX package's distinct minimizers, sequence by sequence (pieces of
    several buckets, a sequence shorter than w)."""
    seen = _spy_extract(monkeypatch, tbuilder)
    seqs = _random_seqs(np.random.default_rng(5), [5000, 2100, 700, 25])
    for i, s in enumerate(seqs):
        got = tbuilder.sequence_hashes(s, K, W, device="cpu")
        want = jax_sequence_hashes(s, K, W)
        assert np.array_equal(got, np.unique(want)), i
    assert seen and not any(seen)


def test_device_build_pipeline_skips_the_zero_tail(monkeypatch):
    """The two-pass build's pass-1 extraction asks for no zero tail and
    still counts the JAX pipeline's distinct minimizers per target."""
    seen = _spy_extract(monkeypatch, tdb)
    rng = np.random.default_rng(6)
    files = {f"T{t}": [_random_seqs(rng, [3000, 1200])] for t in range(3)}

    def counts(pipe):
        try:
            for target, fs in files.items():
                for fi, seqs in enumerate(fs):
                    for s in seqs:
                        enc, _ = encode_seqs([s], max_len=len(s))
                        pipe.add_sequence((target, fi), enc[0])
            pipe.finish_counts()
            return pipe.hashes_count()
        finally:
            pipe.close()

    got = counts(tdb.DeviceBuildPipeline(K, W, device="cpu"))
    want = counts(JaxPipeline(K, W))
    assert got == want and all(got.values())
    assert seen and not any(seen)
