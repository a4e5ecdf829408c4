"""Device meshes for classify: a (batch, bins) grid of torch devices.

Port of ``ganon_tpu.parallel.mesh`` (K17). The JAX package replaces the
reference's CPU-thread data parallelism with a 2-D device mesh:

* axis ``batch``: read batches are data-parallel (each row of devices
  hashes and counts its share of the reads),
* axis ``bins``: the filter's packed table is column-sharded (each device
  of a row holds a slice of the Bloom bins and counts its own targets).

Here a :class:`Mesh` is a plain grid of ``torch.device`` entries, which
may repeat: the CPU tests build one of eight ``cpu`` entries, and
``chip_smoke.py`` one of several views of ``cuda:0``, so every sharded
kernel and copy runs for real on a host with one card. The sharded
classes of :mod:`ganon_tpu_torch.classify.device` drive the kernels on
each entry explicitly: ``count`` on each column shard with the clamp off,
the partials moved to the row's first device (``.to(...,
non_blocking=True)``, the in-process counterpart of GSPMD's all_gather;
per-target partials ``[B, T_shard]`` in place of JAX's per-byte
``[B, W8]``), ``combine`` summing and clamping them there, and every
row's counts gathered on the filter's home device for ``select``.
"""

from __future__ import annotations

import numpy as np
import torch

# device count -> batch-axis size. bins gets the larger share (column
# sharding divides the table's memory per device; read batches also
# scale across processes via multihost.shard_reads, so the in-mesh batch
# axis stays modest).
_BATCH_AXIS = {1: 1, 2: 1, 4: 2, 8: 2, 16: 4, 32: 4, 64: 8, 128: 8}


def choose_batch_axis(n: int) -> int:
    """Batch-axis size for an n-device mesh (bins gets n // batch)."""
    if n in _BATCH_AXIS:
        return _BATCH_AXIS[n]
    # fallback: largest power-of-two divisor of n not exceeding sqrt(n)
    b = 1
    while (b * 2) ** 2 <= n and n % (b * 2) == 0:
        b *= 2
    return b


class Mesh:
    """A ``[batch, bins]`` grid of ``torch.device`` (entries may repeat).

    ``devices[i]`` is batch row ``i``; its first entry is the row's
    device for extraction, the partials' sum and the row's counts.
    """

    def __init__(self, grid):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        if not self.devices or len({len(r) for r in self.devices}) != 1 or (
                not self.devices[0]):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape = {"batch": len(self.devices),
                      "bins": len(self.devices[0])}
        self.size = self.shape["batch"] * self.shape["bins"]

    @property
    def flat(self) -> list:
        """The devices in row-major order."""
        return [d for row in self.devices for d in row]

    def key(self) -> tuple:
        """Identity of the mesh (its shape and devices), for caches."""
        return (self.shape["batch"], self.shape["bins"],
                tuple(str(d) for d in self.flat))


def local_devices() -> list:
    """This process's CUDA devices, ``cuda:0`` .. ``cuda:n-1``.

    The one place a mesh learns the devices: the tests replace it with a
    list of ``cpu`` entries and ``chip_smoke.py`` with several views of
    ``cuda:0``.
    """
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, batch_axis: int | None = None) -> Mesh:
    """Build a (batch, bins) mesh over the given or the local devices."""
    if devices is None:
        devices = local_devices()
    n = len(devices)
    if batch_axis is None:
        batch_axis = choose_batch_axis(n)
    bins_axis = n // batch_axis
    return Mesh([devices[i * bins_axis:(i + 1) * bins_axis]
                 for i in range(batch_axis)])


class ShardedClassifier:
    """An IBF sharded over a mesh, counting read batches end to end.

    Rides the production path (:mod:`ganon_tpu_torch.classify.device`):
    the table is a mesh-sharded ``DeviceFilter``, so extraction with
    compaction, the shards' counts and their combine are the code the
    engine runs. Reads overflowing the compaction width re-run
    uncompacted (exact either way). ``ibf`` is an IBF, or a single-device
    ``DeviceFilter`` whose packed table is cut into the shards on its
    device (no second host repack). The results come back on the
    filter's device (for an IBF, the mesh's first entry).
    """

    def __init__(self, ibf, mesh: Mesh):
        from ganon_tpu_torch.classify.device import DeviceFilter

        self.mesh = mesh
        self.cfg = ibf.ibf_config
        if isinstance(ibf, DeviceFilter):
            self.f = ibf.with_mesh(mesh)
        else:
            self.f = DeviceFilter(ibf, mesh.devices[0][0], mesh=mesh)
        self.num_targets = self.f.num_targets
        self.batch_mult = mesh.shape["batch"]

    def counts(self, codes: np.ndarray, lengths: np.ndarray):
        """codes uint8 [B, L] / lengths int32 [B] -> (counts int32 [B, T],
        n_hashes int32 [B]), tensors on the filter's home device."""
        from ganon_tpu_torch.classify import device as dev
        from ganon_tpu_torch.ops.ibf_query import extract

        B, L = codes.shape
        B_pad = -(-B // self.batch_mult) * self.batch_mult
        if B_pad != B:
            codes = np.pad(codes, ((0, B_pad - B), (0, 0)))
            lengths = np.pad(lengths, (0, B_pad - B))
        k, w = self.cfg.kmer_size, self.cfg.window_size
        L4 = -(-max(L, 1) // 4) * 4  # the extract kernel's 2-bit rows
        m1 = max(L4 - w + 1, 1)
        inbuf = np.zeros((B_pad, L4 // 4 + 4), dtype=np.uint8)
        inbuf[:, : L4 // 4] = dev.pack_codes_2bit(codes)
        inbuf[:, L4 // 4:] = np.asarray(lengths, dtype="<i4").view(
            np.uint8).reshape(B_pad, 4)
        f = self.f
        counts, n_hashes = [], []
        for i, x in enumerate(f.put_batch(inbuf)):
            hashes, n, ovf = extract(x, L1=L4, L2=0, k=k, w=w,
                                     mc=dev.compact_width(m1))
            if bool(ovf.any()):
                hashes, n, _ = extract(x, L1=L4, L2=0, k=k, w=w, mc=m1)
            counts.append(f.row_counts(i, hashes, n))
            n_hashes.append(n)
        counts = dev.gather_rows(counts, f.device)
        n_hashes = dev.gather_rows(n_hashes, f.device)
        return counts[:B], n_hashes[:B]
