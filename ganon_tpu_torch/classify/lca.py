"""Lowest common ancestor over a string-keyed taxonomy DAG.

Euler tour + depth array + sparse-table RMQ, O(1) pairwise queries folded
over match lists — functional equivalent of the reference LCA
(``pirovc/ganon:src/utils/include/utils/LCA.hpp:11-174``). The core
runs in C++ (ganon_tpu_torch/native/lca.cpp, the reference's LCA is native
too); this module keeps the string<->id encoding and falls back to a
numpy + iterative-DFS implementation when no compiler is available.
"""

from __future__ import annotations

import numpy as np


class LCA:
    def __init__(self):
        self._children: dict[str, list[str]] = {}
        self._edges: list[tuple[str, str]] = []
        self._encode: dict[str, int] = {}
        self._decode: list[str] = []
        self._euler: np.ndarray | None = None
        self._first: np.ndarray | None = None
        self._sparse: np.ndarray | None = None
        self._depth: np.ndarray | None = None
        self._native = None
        self._reachable: np.ndarray | None = None

    def add_edge(self, parent: str, child: str) -> None:
        for node in (parent, child):
            if node not in self._encode:
                self._encode[node] = len(self._decode)
                self._decode.append(node)
        if parent != child:  # guard self-loops (root listing itself)
            self._children.setdefault(parent, []).append(child)
            self._edges.append((parent, child))

    def build(self, root: str) -> None:
        """Euler walk from ``root`` + sparse-table RMQ preprocessing."""
        try:
            from ganon_tpu_torch.native import NativeLCA

            if NativeLCA.available():
                enc = self._encode
                parents = np.fromiter(
                    (enc[p] for p, _ in self._edges), dtype=np.int32,
                    count=len(self._edges),
                )
                children = np.fromiter(
                    (enc[c] for _, c in self._edges), dtype=np.int32,
                    count=len(self._edges),
                )
                self._native = NativeLCA(
                    parents, children, len(self._decode), enc[root]
                )
                self._reachable = self._native.reachable()
                return
        except Exception:
            self._native = None
        self._build_py(root)

    def _build_py(self, root: str) -> None:
        n = len(self._decode)
        first = np.full(n, -1, dtype=np.int64)
        euler: list[int] = []
        depth: list[int] = []
        # iterative DFS preserving child order (reference does recursive DFS
        # appending the parent again after each child subtree)
        stack: list[tuple[str, int, int]] = [(root, 0, 0)]  # node, depth, child_idx
        while stack:
            node, d, ci = stack.pop()
            enc = self._encode[node]
            if ci == 0 and first[enc] == -1:
                first[enc] = len(euler)
            # initial visit (ci == 0) or re-append after finishing child ci-1
            euler.append(enc)
            depth.append(d)
            children = self._children.get(node, ())
            if ci < len(children):
                stack.append((node, d, ci + 1))
                stack.append((children[ci], d + 1, 0))

        self._euler = np.asarray(euler, dtype=np.int64)
        self._depth = np.asarray(depth, dtype=np.int64)
        self._first = first

        m = len(euler)
        log = max(1, int(np.ceil(np.log2(max(m, 2)))))
        sparse = np.empty((log + 1, m), dtype=np.int64)
        sparse[0] = np.arange(m)
        dep = self._depth
        for j in range(1, log + 1):
            span = 1 << j
            half = 1 << (j - 1)
            if half >= m:
                sparse[j] = sparse[j - 1]
                continue
            prev = sparse[j - 1]
            a = prev[: m - half]
            b = prev[half:]
            sparse[j, : m - half] = np.where(dep[a] < dep[b], a, b)
            sparse[j, m - half :] = prev[m - half :]
        self._sparse = sparse

    def _rmq(self, i: int, j: int) -> int:
        i, j = int(i), int(j)
        if i > j:
            i, j = j, i
        k = (j - i + 1).bit_length() - 1
        a = self._sparse[k, i]
        b = self._sparse[k, j - (1 << k) + 1]
        return a if self._depth[a] <= self._depth[b] else b

    def lca_pair(self, u: int, v: int) -> int:
        if self._native is not None:
            return self._native.pair(u, v)
        if u == v:
            return u
        fu, fv = self._first[u], self._first[v]
        if fu > fv:
            fu, fv = fv, fu
        return self._euler[self._rmq(fu, fv)]

    def __contains__(self, node: str) -> bool:
        if node not in self._encode:
            return False
        if self._native is not None:
            return bool(self._reachable[self._encode[node]])
        return self._first is None or self._first[self._encode[node]] != -1

    def encode_ids(self, names) -> np.ndarray:
        """Map node names to integer ids (-1 for names outside the DAG)."""
        enc = self._encode
        return np.fromiter(
            (enc.get(n, -1) for n in names), dtype=np.int32,
            count=len(names),
        )

    def decode_id(self, i: int) -> str:
        return self._decode[i]

    def lca_rows(self, ids_mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Per-row LCA over ``ids_mat[r, :lens[r]]`` for a whole batch.

        Uses the set identity ``lca(S) = euler[rmq(min_f, max_f)]`` with
        ``f = first[·]`` — one range query per row instead of a pairwise
        fold (identical result on a tree), so the host finish does one
        vectorized pass instead of a Python loop per multi-match read.
        Raises KeyError if any row contains an unreachable id.
        """
        ids_mat = np.ascontiguousarray(ids_mat, dtype=np.int32)
        lens = np.asarray(lens)
        if self._native is not None:
            out = self._native.lca_rows(ids_mat, lens)
            if (out[lens > 0] < 0).any():
                raise KeyError("LCA query outside the tree")
            return out
        R, K = ids_mat.shape
        out = np.full(R, -1, dtype=np.int32)
        rows = np.nonzero(lens > 0)[0]
        if not len(rows):
            return out
        valid = np.arange(K)[None, :] < lens[rows, None]
        ids = ids_mat[rows]
        iv = ids[valid]
        if ((iv < 0) | (iv >= len(self._first))).any() \
                or (self._first[iv] < 0).any():
            raise KeyError("LCA query outside the tree")
        f = np.where(valid, self._first[np.where(valid, ids, 0)],
                     np.int64(np.iinfo(np.int64).max))
        fmin = f.min(axis=1)
        f2 = np.where(valid, f, -1)
        fmax = f2.max(axis=1)
        i, j = fmin, fmax
        span = (j - i + 1).astype(np.float64)
        k = (np.frexp(span)[1] - 1).astype(np.int64)  # floor(log2)
        a = self._sparse[k, i]
        b = self._sparse[k, j - (np.int64(1) << k) + 1]
        best = np.where(self._depth[a] <= self._depth[b], a, b)
        res = self._euler[best].astype(np.int32)
        single = lens[rows] == 1
        res[single] = ids[single, 0]
        out[rows] = res
        return out

    def lca(self, nodes: list[str]) -> str:
        """LCA of a list of node names (folds pairwise, order-invariant)."""
        assert len(nodes) >= 1
        if len(nodes) == 1:
            return nodes[0]
        enc = self._encode
        if self._native is not None:
            ids = np.fromiter(
                (enc[n] for n in nodes), dtype=np.int32, count=len(nodes)
            )
            cur = self._native.lca_list(ids)
            if cur < 0:
                raise KeyError(f"LCA query outside the tree: {nodes}")
            return self._decode[cur]
        cur = self.lca_pair(enc[nodes[0]], enc[nodes[1]])
        for name in nodes[2:]:
            cur = self.lca_pair(cur, enc[name])
        return self._decode[cur]


def build_lca(tax: dict[str, tuple[str, str, str]], root: str) -> LCA:
    """LCA from a {target: (parent, rank, name)} tax table (reference
    pre_process_lca, GanonClassify.cpp:1364-1371)."""
    lca = LCA()
    for target, (parent, _rank, _name) in tax.items():
        lca.add_edge(parent, target)
    lca.build(root)
    return lca
