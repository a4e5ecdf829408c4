"""Winnowed canonical minimizer extraction (seqan3-compatible semantics).

Port of ``ganon_tpu.ops.minimizers``; the semantics are documented there:

* dna4 alphabet A=0, C=1, G=2, T=3 (U -> T, anything else -> A);
* forward k-mer value ``v = (v << 2) | rank``, reverse complement packed
  the same way from ``3 - rank`` in reverse order;
* both XORed with ``adjust_seed(k)`` before the elementwise minimum;
* a window of ``w - k + 1`` canonical values emits its minimum whenever
  the window's leftmost-argmin position changes.

Torch has no unsigned 64-bit arithmetic beyond ``^``, ``*`` and sort, so
u64 values are held as ``int64`` bit patterns and the helpers below do
the unsigned shifts and compares. The invalid-position sentinel
``U64_MAX`` is ``-1`` in that representation: a signed ``min`` would
pick it, every minimum here is unsigned.

:func:`minimizers_masked` is the plain torch version of the classify-path
extraction; the CUDA ``extract`` kernel (``csrc/extract.cu``) computes
the same emissions, compacted (``ops.ibf_query.extract``).
"""

from __future__ import annotations

import numpy as np
import torch

_SEED64 = 0x8F3F73B5CF1C9ADE
_U64_MAX = 0xFFFFFFFFFFFFFFFF
# int64 bit pattern of U64_MAX (the invalid k-mer sentinel)
U64_MAX_I64 = -1
_SIGN = -(1 << 63)


def adjust_seed(k: int, seed: int = _SEED64) -> int:
    """Shift the 64-bit seed so it only touches the 2k used bits.

    Reference: pirovc/ganon:src/utils/include/utils/adjust_seed.hpp:33-37.
    """
    return seed >> (64 - 2 * k)


# --- u64 helpers on int64 bit patterns ---------------------------------------


def as_i64(v: int) -> int:
    """A Python integer in [0, 2^64) as the int64 with the same bits."""
    v &= _U64_MAX
    return v - (1 << 64) if v >> 63 else v


def u64_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def torch_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 bit patterns -> numpy uint64 array."""
    return t.detach().cpu().numpy().view(np.uint64)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical (unsigned) right shift of int64 bit patterns by ``s`` < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ukey(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of u64 bit patterns onto signed int64."""
    return x ^ _SIGN


def ule(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a <= b`` on int64 bit patterns."""
    return ukey(a) <= ukey(b)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned elementwise minimum on int64 bit patterns."""
    return torch.where(ule(a, b), a, b)


# --- host-side sequence encoding -------------------------------------------

# byte -> dna4 rank; default 0 (A), U/u -> T
_ENCODE_LUT = np.zeros(256, dtype=np.uint8)
for _c, _r in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3), (b"U", 3)):
    _ENCODE_LUT[_c[0]] = _r
    _ENCODE_LUT[_c[0] + 32] = _r  # lowercase


def encode_seqs(seqs, max_len: int | None = None):
    """Encode a list of sequences (str/bytes) into a padded rank matrix.

    Returns ``(codes uint8 [B, L], lengths int32 [B])``. Padding rank is 0
    (A) — downstream masking by length makes the pad value irrelevant.
    """
    if max_len is None:
        max_len = max((len(s) for s in seqs), default=0)
    B = len(seqs)
    codes = np.zeros((B, max_len), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode()
        b = np.frombuffer(s[:max_len], dtype=np.uint8)
        codes[i, : len(b)] = _ENCODE_LUT[b]
        lengths[i] = len(s)
    return codes, lengths


# --- golden model (exact, slow; mirrors the stateful deque algorithm) ------


def _kmer_values(ranks, k: int, seed: int):
    """Forward/revcomp packed k-mer values XOR seed, as Python ints."""
    n = len(ranks) - k + 1
    fwd, rc = [], []
    for i in range(n):
        f = 0
        r = 0
        for j in range(k):
            f = (f << 2) | int(ranks[i + j])
            r |= (3 - int(ranks[i + j])) << (2 * j)
        fwd.append(f ^ seed)
        rc.append(r ^ seed)
    return fwd, rc


def minimizers_golden(seq, k: int, w: int):
    """Reference implementation with Python ints (used only by tests).

    Returns the list of emitted minimizer values for one sequence.
    """
    if isinstance(seq, (str, bytes)):
        if isinstance(seq, str):
            seq = seq.encode()
        ranks = _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
    else:
        ranks = np.asarray(seq)
    if len(ranks) < w:
        return []
    seed = adjust_seed(k)
    fwd, rc = _kmer_values(ranks, k, seed)
    canon = [min(f, r) for f, r in zip(fwd, rc)]
    ww = w - k + 1  # values per window
    out = []
    # stateful emission: first window, then slide
    window = canon[:ww]
    pos = min(range(ww), key=lambda t: window[t])  # leftmost argmin
    out.append(window[pos])
    for t in range(1, len(canon) - ww + 1):
        new_val = canon[t + ww - 1]
        if pos < t:  # minimiser slid out -> rescan (leftmost), always emit
            pos = min(range(t, t + ww), key=lambda q: canon[q])
            out.append(canon[pos])
        elif new_val < canon[pos]:  # strictly smaller enters -> emit
            pos = t + ww - 1
            out.append(new_val)
    return out


# --- plain torch extraction ---------------------------------------------------


def canonical_values(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical (unsigned min of fwd/rc, seed-XORed) k-mer values.

    ``codes`` int64/uint8 ``[B, L]`` ranks -> int64 ``[B, L-k+1]`` u64
    bit patterns; positions whose k-mer runs past the read are
    ``U64_MAX`` (-1).
    """
    c = codes.to(torch.int64)
    L = c.shape[1]
    nk = L - k + 1
    fwd = torch.zeros((c.shape[0], nk), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        cj = c[:, j : j + nk]
        fwd = (fwd << 2) | cj  # wraps mod 2^64 at k == 32, as u64 does
        rc = rc | ((3 - cj) << (2 * j))
    seed = as_i64(adjust_seed(k))
    canon = umin(fwd ^ seed, rc ^ seed)
    kpos = torch.arange(nk, device=c.device)[None, :]
    return torch.where(kpos + k <= lengths[:, None].to(torch.int64), canon,
                       torch.full_like(canon, U64_MAX_I64))


def _window_argmin(canon: torch.Tensor, ww: int, nw: int):
    """Leftmost argmin over sliding windows of ``ww`` values (doubling).

    The doubling of ``ganon_tpu.ops.minimizers._window_argmin``: spans
    combine taking the left side on ``<=``, then the two overlapping
    spans covering ``ww`` merge the same way.
    """
    val = ukey(canon)  # signed order == unsigned order of the bits
    pos = torch.arange(canon.shape[1], device=canon.device).expand_as(canon)
    s = 1
    while s * 2 <= ww:
        n = val.shape[1] - s
        take_left = val[:, :n] <= val[:, s:]
        val = torch.where(take_left, val[:, :n], val[:, s:])
        pos = torch.where(take_left, pos[:, :n], pos[:, s:])
        s *= 2
    lv, rv = val[:, :nw], val[:, ww - s : ww - s + nw]
    take_left = lv <= rv
    return (
        ukey(torch.where(take_left, lv, rv)),
        torch.where(take_left, pos[:, :nw], pos[:, ww - s : ww - s + nw]),
    )


def minimizers_masked(codes: torch.Tensor, lengths: torch.Tensor, *,
                      k: int, w: int):
    """Minimizers as (window-min values, emission mask) — no compaction.

    Plain torch version of ``ganon_tpu.ops.minimizers.minimizers_masked_jax``.
    Returns ``(minval int64 [B, L-w+1], emit bool [B, L-w+1],
    n_hashes int32 [B])``; a row shorter than ``w`` emits nothing.
    """
    B, L = codes.shape
    dev = codes.device
    if L < w:
        return (
            torch.zeros((B, 1), dtype=torch.int64, device=dev),
            torch.zeros((B, 1), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
        )
    canon = canonical_values(codes, lengths, k)
    ww = w - k + 1
    nw = L - w + 1
    minval, minpos = _window_argmin(canon, ww, nw)
    wpos = torch.arange(nw, device=dev)[None, :]
    valid_w = wpos + w <= lengths[:, None].to(torch.int64)
    emit = torch.cat(
        [valid_w[:, :1], valid_w[:, 1:] & (minpos[:, 1:] != minpos[:, :-1])],
        dim=1,
    )
    n_hashes = emit.sum(dim=1, dtype=torch.int32)
    return minval, emit, n_hashes
