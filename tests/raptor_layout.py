"""Raptor ``.hibf`` archives in the shape of raptor's own layouts.

The port writes one archive kind itself (``export_raptor_hibf``: a root
of merged bins over the forest's classes). The reference's DP layout
also puts user bins beside merged bins, splits large user bins over many
technical bins and may place one user bin in several IBFs; the tests and
``chip_smoke.py`` build such archives with :func:`write_raptor_layout`.
Imports neither jax nor the JAX package, so ``chip_smoke.py`` can use it
on the card's machine; it loads this file by its path, and the tests
import it as ``raptor_layout`` (pytest puts ``tests/`` on the path).
"""

import numpy as np

from ganon_tpu_torch.index.hibf import _write_raptor_tree
from ganon_tpu_torch.index.ibf import build_ibf


def write_raptor_layout(target_hashes: dict[str, np.ndarray], layout: list,
                        path: str, *, kmer_size: int, window_size: int,
                        max_fp: float = 0.05, hash_functions=0,
                        device="cuda") -> None:
    """Build the IBFs of a raptor layout and write them as a ``.hibf``.

    ``layout`` lists the IBFs, IBF 0 the root, each as ``(users,
    children)``: the targets it holds as user bins and the IBF ids of its
    merged bins, one per child, each the union of the child's subtree.
    Every IBF is ``build_ibf`` of its bins on ``device`` (a large user bin
    splits over several technical bins as the sizing gives it), with
    ``hash_functions`` one value or one per IBF (0: the sizing's).
    """
    hfs = (list(hash_functions) if isinstance(hash_functions, (list, tuple))
           else [hash_functions] * len(layout))

    def subtree(i: int) -> list:
        users, children = layout[i]
        return list(users) + [t for c in children for t in subtree(c)]

    tree = []
    for i, (users, children) in enumerate(layout):
        bins = {t: target_hashes[t] for t in users}
        for c in children:
            bins[f"merged{c}"] = np.unique(np.concatenate(
                [np.asarray(target_hashes[t], dtype=np.uint64)
                 for t in subtree(c)]))
        ibf = build_ibf(bins, kmer_size=kmer_size, window_size=window_size,
                        max_fp=max_fp, hash_functions=hfs[i], device=device)
        tree.append((ibf, list(users), {f"merged{c}": c for c in children}))
    _write_raptor_tree(path, tree, kmer_size=kmer_size,
                       window_size=window_size, max_fp=max_fp)
