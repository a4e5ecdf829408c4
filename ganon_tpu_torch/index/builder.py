"""Per-target minimizer extraction for index construction.

Port of the extraction half of ``ganon_tpu.index.builder``
(``_HashExtractor``, ``sequence_hashes``). Sequences are cut into pieces
with ``w - 1`` bases of overlap, so every window lies in exactly one
piece, and the pieces go through the ``extract`` kernel in single-end
mode with a capacity of every window position (it never overflows). The
set of emitted minimizers equals the set of window minima, so the
per-target ``np.unique`` of the emissions is the target's minimizer set,
as ``ganon_tpu``'s ``finish`` computes it (there with ``np.unique``;
here with the same sort-based result, see :func:`_sorted_unique`).

The pieces are shorter than the JAX package's 256 kbp chunks: the
kernel walks one piece per thread, and many short pieces keep every SM
busy. The piece length changes no result.
"""

from __future__ import annotations

import numpy as np
import torch

from ganon_tpu_torch.classify.device import pack_codes_2bit
from ganon_tpu_torch.ops.ibf_query import extract
from ganon_tpu_torch.ops.minimizers import encode_seqs, torch_to_u64

# bases per piece handed to one kernel thread (multiple of 4); a window
# wider than half of it gets pieces of 2w bases
PIECE = 1 << 11
# pieces per kernel launch
PIECES_PER_BATCH = 16384


def _bucket(n: int, cap: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, cap)


class _HashExtractor:
    """Batched device minimizer extraction, deduplicated per key.

    ``add``/``add_encoded`` queue a sequence (str or dna4 ranks) under a
    key; pieces of equal bucket length are packed 2-bit into one buffer
    per launch. ``finish`` returns ``{key: sorted distinct minimizers}``
    as uint64 arrays.
    """

    def __init__(self, k: int, w: int, device="cuda"):
        self.k, self.w = k, w
        self.piece = max(PIECE, -(-2 * w // 4) * 4)
        self.device = torch.device(device)
        self.bufs: dict[int, list] = {}    # bucket L -> [(key, codes)]
        self.out: dict[object, list] = {}  # key -> [np.uint64 arrays]

    def add(self, key, seq: str) -> None:
        if len(seq) < self.w:
            return
        enc, _ = encode_seqs([seq], max_len=len(seq))
        self.add_encoded(key, enc[0])

    def add_encoded(self, key, row: np.ndarray) -> None:
        """Add one dna4-encoded sequence (uint8 [n]), cut into pieces."""
        if len(row) < self.w:
            return
        step = self.piece - (self.w - 1)
        for s in range(0, len(row) - self.w + 1, step):
            piece = row[s : s + self.piece]
            L = _bucket(len(piece), self.piece)
            buf = self.bufs.setdefault(L, [])
            buf.append((key, piece))
            if len(buf) >= PIECES_PER_BATCH:
                self._submit(L)

    def _submit(self, L: int) -> None:
        buf = self.bufs.pop(L, [])
        if not buf:
            return
        B = len(buf)
        codes = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros((B,), dtype="<i4")
        for i, (_, piece) in enumerate(buf):
            codes[i, : len(piece)] = piece
            lengths[i] = len(piece)
        inbuf = np.concatenate(
            [pack_codes_2bit(codes), lengths.view(np.uint8).reshape(B, 4)],
            axis=1,
        )
        hashes, n, _ = extract(
            torch.from_numpy(inbuf).to(self.device), L1=L, L2=0,
            k=self.k, w=self.w, mc=L - self.w + 1,
        )
        keep = torch.arange(hashes.shape[1], device=self.device)[None, :] < n[:, None]
        vals = torch_to_u64(hashes[keep])
        counts = n.cpu().numpy()
        off = 0
        for (key, _), c in zip(buf, counts.tolist()):
            if c:
                self.out.setdefault(key, []).append(vals[off : off + c])
            off += c

    def finish(self) -> dict[object, np.ndarray]:
        for L in list(self.bufs):
            self._submit(L)
        return {
            key: _sorted_unique(np.concatenate(parts))
            for key, parts in self.out.items()
        }


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by sort and adjacent compare. numpy >= 2.3 routes
    ``np.unique`` of uint64 through a hash table: 77 ms against 1.9 ms
    for this sort on 160k values, measured on the H100 machine's host
    (numpy 2.3.5), which made it the build's bottleneck."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if len(a) else a


def sequence_hashes(seq: str, k: int, w: int, device="cuda") -> np.ndarray:
    """Distinct minimizer values of one sequence."""
    ex = _HashExtractor(k, w, device)
    ex.add(0, seq)
    res = ex.finish()
    return res.get(0, np.empty(0, dtype=np.uint64))
