"""The port's index build against ``ganon_tpu``'s, byte for byte.

Same target hashes in, same filter out: the bit-matrix, IBFConfig,
hashes_count and bin_map are equal (the scatter's plain version runs on
the CPU). Extraction gives the same per-target minimizer sets, and each
package loads the ``.ibf`` files the other writes.
"""

import os

import numpy as np
import pytest

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.index import builder as jbuilder
from ganon_tpu.index.ibf import IBF as JaxIBF
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu_torch.index import builder as tbuilder
from ganon_tpu_torch.index.ibf import IBF, build_ibf

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _target_hashes(seed):
    """Sorted distinct u64 'minimizers' per target; one target is much
    larger, so the sizing splits it over several technical bins."""
    rng = np.random.default_rng(seed)
    sizes = [9000, 700, 1500, 40, 1]
    return {
        f"T{i}": np.unique(rng.integers(0, 2**64, size=n, dtype=np.uint64))
        for i, n in enumerate(sizes)
    }


def _assert_same_ibf(a, b):
    assert np.array_equal(np.asarray(a.bits), np.asarray(b.bits))
    assert a.ibf_config.to_dict() == b.ibf_config.to_dict()
    assert a.hashes_count == b.hashes_count
    assert [tuple(x) for x in a.bin_map] == [tuple(x) for x in b.bin_map]


@pytest.mark.parametrize("kw", [
    dict(max_fp=0.05),
    dict(max_fp=0.01, hash_functions=4, tpu_sizing=False),
    dict(max_fp=0.0, filter_size=0.05, mode="fastest"),
], ids=["auto-h", "h4", "filter-size"])
def test_build_ibf_matches_jax(kw):
    hashes = _target_hashes(11)
    want = jax_build_ibf(hashes, kmer_size=19, window_size=31, **kw)
    got = build_ibf(hashes, kmer_size=19, window_size=31, device="cpu", **kw)
    if "filter_size" not in kw:
        assert len(want.bin_map) > len(hashes)  # a target split over bins
    assert got.bits.dtype == np.uint32
    _assert_same_ibf(got, want)


def test_hash_extractor_matches_jax():
    k, w = 19, 31
    rng = np.random.default_rng(3)
    seqs = {
        "long": rng.integers(0, 4, size=5 * tbuilder.PIECE + 77),
        "piece": rng.integers(0, 4, size=tbuilder.PIECE),
        "short": rng.integers(0, 4, size=w),
        "tiny": rng.integers(0, 4, size=w - 1),
        "repeat": np.tile(rng.integers(0, 4, size=40), 50),
    }
    jx = jbuilder._HashExtractor(k, w)
    tx = tbuilder._HashExtractor(k, w, device="cpu")
    for key, s in seqs.items():
        jx.add_encoded(key, s.astype(np.uint8))
        tx.add_encoded(key, s.astype(np.uint8))
    jx.add("str", "ACGTN" * 40)
    tx.add("str", "ACGTN" * 40)
    want, got = jx.finish(), tx.finish()
    assert set(got) == set(want) == set(seqs) - {"tiny"} | {"str"}
    for key in want:
        assert got[key].dtype == np.uint64
        assert np.array_equal(got[key], want[key]), key
    assert np.array_equal(
        tbuilder.sequence_hashes("ACGT" * 30, k, w, device="cpu"),
        jbuilder.sequence_hashes("ACGT" * 30, k, w),
    )


def test_hash_extractor_window_wider_than_piece(monkeypatch):
    """A window wider than a piece: pieces grow to 2w bases, so every
    window still lies in one piece."""
    monkeypatch.setattr(tbuilder, "PIECE", 64)
    k, w = 15, 70
    seq = np.random.default_rng(4).integers(0, 4, size=1000).astype(np.uint8)
    jx = jbuilder._HashExtractor(k, w)
    tx = tbuilder._HashExtractor(k, w, device="cpu")
    jx.add_encoded("t", seq)
    tx.add_encoded("t", seq)
    assert np.array_equal(tx.finish()["t"], jx.finish()["t"])
    assert tx.piece == 140


@pytest.mark.parametrize("raw", [False, True], ids=["npz", "raw"])
def test_ibf_files_cross_load(tmp_path, raw):
    jibf = jax_build_ibf(_target_hashes(5), kmer_size=15, window_size=23,
                         max_fp=0.05)
    port = IBF.from_arrays(jibf.bits, jibf.ibf_config.to_dict(),
                           jibf.hashes_count, jibf.bin_map)
    a, b = str(tmp_path / "jax.ibf"), str(tmp_path / "port.ibf")
    (jibf.save_raw if raw else jibf.save)(a)
    (port.save_raw if raw else port.save)(b)
    _assert_same_ibf(IBF.load(a), jibf)
    _assert_same_ibf(JaxIBF.load(b), jibf)
    if raw:
        assert open(a, "rb").read() == open(b, "rb").read()


def test_cereal_ibf_is_not_ported_yet():
    """The reference's cereal archive (ported since): IBF.load reads the
    frozen golden fixture to the JAX reader's arrays."""
    from ganon_tpu.index.serialize import read_ibf

    path = os.path.join(FIXDIR, "golden_h1.ibf")
    _assert_same_ibf(IBF.load(path), read_ibf(path))
