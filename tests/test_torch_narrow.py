"""Host sides of the redesigned count and the wide-window extract route,
on the CPU, against the JAX package.

``ops.ibf_query.raptor_target_counts`` counts every sub of a raptor
archive in one launch on the card (``csrc/count.cu`` ``count_raptor``);
its plain version, which the CPU takes, must equal JAX's
``DeviceRaptorHIBF.counts``, and the sub-descriptor array the kernel
reads (``sub_descriptors``, built when the archive loads) must describe
each sub's tables. ``extract`` takes a route of its own on the card for
windows too wide for a tile's shared memory (``extract_is_wide``); on the
CPU the plain version serves every window, and at the first wide window
(k 19, w 18,104) it must give JAX's minimizers. Counts and hashes are
integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganon_tpu  # noqa: F401  (turns on jax x64)
from ganon_tpu.classify import device as jdev
from ganon_tpu.index.hibf import RaptorHIBF as JaxRaptorHIBF
from ganon_tpu.ops.minimizers import minimizers_golden, minimizers_jax
from ganon_tpu_torch.classify import device as tdev
from ganon_tpu_torch.index.hibf import RaptorHIBF
from ganon_tpu_torch.ops import ibf_query as q
from tests.test_torch_raptor import (  # noqa: F401  (fixtures)
    _hashes_batch,
    genomes,
    layouts,
)

K = 19
WIDE_W = 18_104  # the first w at k 19 past a tile's shared memory


@pytest.mark.parametrize("name", ["user-bin-in-two-ibfs",
                                  "root-users-and-merged", "routing-only-ibf"])
def test_raptor_target_counts_plain_matches_jax(layouts, genomes, name):
    """The one-launch call's plain version (and the wrapper on CPU
    tensors) against JAX's DeviceRaptorHIBF.counts: user bins in two IBFs,
    a split user bin, a routing-only IBF, hash counts that differ."""
    tf = tdev.DeviceRaptorHIBF(RaptorHIBF.load(layouts[name]), "cpu")
    jf = jdev.DeviceRaptorHIBF(JaxRaptorHIBF.load(layouts[name]))
    h, n = _hashes_batch(genomes)
    mask = jnp.asarray(np.arange(h.shape[1])[None, :] < n.numpy()[:, None])
    want = np.asarray(jf.counts(jnp.asarray(h.numpy().view(np.uint64)), mask,
                                jnp.asarray(n.numpy())))
    plain = q.raptor_target_counts_plain(tf.subs, h, n,
                                         num_targets=tf.num_targets)
    wrapped = q.raptor_target_counts(tf.subs, h, n,
                                     num_targets=tf.num_targets,
                                     desc=tf.sub_desc)
    assert plain.dtype == torch.int32 and wrapped.dtype == torch.int32
    assert np.array_equal(plain.numpy(), want)
    assert torch.equal(wrapped, plain)
    assert want.max() > 0


def test_sub_descriptors_describe_the_subs(layouts):
    """One int64 row a sub: the table's pointer and u32 words a row, the
    byte ranges' pointers, the target count, bin size, hash functions,
    clz64(bin size) and the columns' pointer; made anew when the archive
    moves; a hash count past 5 refused."""
    tf = tdev.DeviceRaptorHIBF(RaptorHIBF.load(
        layouts["user-bin-in-two-ibfs"]), "cpu")
    desc = tf.sub_desc
    assert desc.dtype == torch.int64 and desc.shape == (len(tf.subs), 9)
    assert len(q.SUB_DESC_FIELDS) == 9
    for row, sub in zip(desc.tolist(), tf.subs):
        assert row == [sub.tbl8.data_ptr(), sub.tbl8.shape[1] // 4,
                       sub.byte_starts.data_ptr(), sub.byte_ends.data_ptr(),
                       sub.byte_starts.shape[0], sub.bin_size, sub.hash_funs,
                       q.clz64(sub.bin_size), sub.cols.data_ptr()]
    # the hash counts of this layout's IBFs differ (2, then the sizing's)
    assert len({row[6] for row in desc.tolist()}) == 2
    moved = tf.to("cpu")
    assert torch.equal(moved.sub_desc, q.sub_descriptors(moved.subs))
    with pytest.raises(ValueError, match="hash_functions or bin_size"):
        q.sub_descriptors([tdev.RaptorSub(
            tbl8=tf.subs[0].tbl8, byte_starts=tf.subs[0].byte_starts,
            byte_ends=tf.subs[0].byte_ends, bin_size=tf.subs[0].bin_size,
            hash_funs=6, cols=tf.subs[0].cols)])
    assert q.sub_descriptors([]).shape == (0, 9)


def test_wide_window_route_threshold():
    """The card's tiled extract holds w up to 18,103 at k 19; from 18,104
    the wide route takes over, and the default w never reaches it."""
    assert not q.extract_is_wide(K, WIDE_W - 1)
    assert q.extract_is_wide(K, WIDE_W)
    assert not q.extract_is_wide(K, 31)
    assert q.extract_is_wide(32, 40_000)


def test_extract_at_a_wide_window_matches_jax():
    """Two 20 kbp reads at k 19, w 18,104 (one cut to 19,500 bases, so a
    short final window run) through extract on the CPU, against
    ganon_tpu's minimizers_jax and its golden walk."""
    rng = np.random.default_rng(18_104)
    L = 20_000
    codes = rng.integers(0, 4, size=(2, L), dtype=np.uint8)
    lens = np.array([L, 19_500], np.int32)
    codes[1, lens[1]:] = 0
    packed = np.zeros((2, L // 4), np.uint8)
    for j in range(4):
        packed |= codes[:, j::4] << (2 * j)
    inbuf = torch.from_numpy(np.concatenate(
        [packed, lens.astype("<i4").view(np.uint8).reshape(2, 4)], axis=1))
    mc = 64
    hashes, n, ovf = q.extract(inbuf, L1=L, L2=0, k=K, w=WIDE_W, mc=mc)
    jh, jn = minimizers_jax(jnp.asarray(codes), jnp.asarray(lens), k=K,
                            w=WIDE_W, max_minimizers=mc)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert np.array_equal(hashes.numpy().view(np.uint64), np.asarray(jh))
    assert not ovf.any() and (n >= 1).all() and int(n.max()) > 1
    for b in range(2):
        gold = minimizers_golden(codes[b, :lens[b]], K, WIDE_W)
        assert [int(x) for x in hashes[b, :n[b]].numpy().view(np.uint64)] \
            == [int(x) for x in gold]
