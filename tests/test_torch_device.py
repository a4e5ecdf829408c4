"""The port's fused batch path against ``ganon_tpu``'s, buffer for buffer.

One seeded database and read batch go through the JAX
``classify_batch_packed(..., pack16=True, match_cap=0)`` and the port's
``classify_batch_packed`` (extract -> count -> select, plain versions on
the CPU); the flat int32 result buffers must be equal, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.ibf import build_ibf as jax_build_ibf
from ganon_tpu.io.pipeline import EncodedBatch
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.builder import _HashExtractor
from ganon_tpu_torch.index.ibf import IBF

READ = 150


def _database(k, w, seed):
    rng = np.random.default_rng(seed)
    genomes = rng.integers(0, 4, size=(7, 2500), dtype=np.uint8)
    ex = _HashExtractor(k, w, device="cpu")
    for t, g in enumerate(genomes):
        ex.add_encoded(f"T{t}", g)
    hashes = ex.finish()
    ibf = jax_build_ibf(hashes, kmer_size=k, window_size=w, max_fp=0.05)
    return genomes, ibf


def _batch(rng, genomes, n, paired, w):
    """Reads sampled from the genomes (mate 2 reverse-complemented), random
    junk, and reads shorter than the window, with mixed lengths."""
    T, G = genomes.shape
    tgt = rng.integers(0, T, size=n)
    lens1 = rng.integers(w, READ + 1, size=n).astype(np.int32)
    lens1[:6] = [0, 1, w - 1, w, READ, READ]
    codes1 = np.zeros((n, READ), np.uint8)
    codes2 = np.zeros((n, READ), np.uint8)
    lens2 = rng.integers(0, READ + 1, size=n).astype(np.int32)
    lens2[:6] = [READ, READ, READ, w - 1, 0, READ]
    for i in range(n):
        p1, p2 = rng.integers(0, G - READ, size=2)
        codes1[i] = genomes[tgt[i], p1:p1 + READ]
        codes2[i] = 3 - genomes[tgt[i], p2:p2 + READ][::-1]
    junk = rng.random(n) < 0.2
    codes1[junk] = rng.integers(0, 4, size=(junk.sum(), READ))
    codes1[np.arange(READ)[None, :] >= lens1[:, None]] = 0
    codes2[np.arange(READ)[None, :] >= lens2[:, None]] = 0
    b = EncodedBatch(prefix="", paired=paired,
                     ids=[f"r{i}" for i in range(n)],
                     codes1=codes1, len1=lens1)
    if paired:
        b.codes2, b.len2 = codes2, lens2
    return b


@pytest.fixture(scope="module", params=[(19, 31), (19, 20)],
                ids=["k19w31", "k19w20"])
def database(request):
    k, w = request.param
    genomes, ibf = _database(k, w, seed=k * 100 + w)
    port = IBF.from_arrays(ibf.bits, ibf.ibf_config.to_dict(),
                           ibf.hashes_count, ibf.bin_map)
    return k, w, genomes, jdev.DeviceFilter(ibf), tdev.DeviceFilter(port, "cpu")


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("top_k,emit,cuts", [
    (8, True, (0.25, 0.1)),
    (3, False, (0.05, 1.0)),
])
def test_classify_batch_packed_matches_jax(database, paired, top_k, emit, cuts):
    k, w, genomes, jf, tf = database
    rng = np.random.default_rng(7 + paired)
    batch = _batch(rng, genomes, 200, paired, w)
    inbuf, L1, L2 = jdev.pack_batch_direct(batch, 256)
    tinbuf, tL1, tL2 = tdev.pack_batch_direct(batch, 256)
    assert (tL1, tL2) == (L1, L2) and np.array_equal(tinbuf, inbuf)
    K = min(top_k, tf.num_targets)
    cfg = jf.ibf_config
    want = np.asarray(jdev.classify_batch_packed(
        jf.tbl8, jf.byte_starts, jf.byte_ends, jnp.asarray(inbuf),
        cuts[0], cuts[1], 65535, k=k, w=w, L1=L1, L2=L2,
        bin_size=cfg.bin_size_bits, hash_functions=cfg.hash_functions,
        top_k=K, pack16=True, match_cap=0, emit_matches_t=emit,
    ))
    got = tdev.classify_batch_packed(
        tf, torch.from_numpy(tinbuf), cuts[0], cuts[1], 65535, k=k, w=w,
        L1=L1, L2=L2, top_k=K, emit_matches_t=emit,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    res = tdev.unpack_batch_result(got.numpy(), 256, K, tf.num_targets,
                                   has_matches_t=emit)
    assert res["n_matches"].any()  # the case classifies something
    if w == 20:
        assert res["overflow"].any()  # dense emission overflows compaction
