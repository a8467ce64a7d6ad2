"""Bidirected edge-centric graph as flat arrays (CSR on demand).

Capability-equivalent of the reference's ``NodeBigraphWrapper<PetGraph>``
(``bigraph``/``traitgraph`` crates; call sites /root/reference/src/bin.rs:349-355,
reference src/implementation/mod.rs:9-16) redesigned for XLA:

- Every unitig is a *biedge*: a forward edge ``n1 -> n2`` and its mirror
  ``mirror(n2) -> mirror(n1)`` carrying the reverse-complement orientation.
  Edges are stored in pairs so ``mirror_edge(e) == e ^ 1``.
- Nodes are (k-1)-mer orientation classes; ``mirror_node`` maps each node to
  its reverse-complement node; a node can be its own mirror (self-mirror,
  i.e. a reverse-complement palindromic (k-1)-mer).
- Storage is structure-of-arrays int32/int64 numpy, so the whole graph can be
  shipped to HBM as-is and indexed by jitted gather/segment ops; dummy edges
  are appended to the same arrays (amortized growth), and adjacency CSR is
  rebuilt on demand with vectorized sorts.

Imbalance semantics (``compute_eulerian_superfluous_out_biedges``; call sites
/root/reference/src/implementation/greedytigs/mod.rs:229-245):
- non-self-mirror node: outdeg - indeg (positive => misses incoming biedges),
- self-mirror node: outdeg mod 2 (odd incident biedge count blocks the
  Eulerian bicycle; each incident biedge contributes one in- and one
  out-edge, so outdeg == indeg there).
"""

from __future__ import annotations

import numpy as np


def _extend_csr(off, order, keys, e0, n):
    """Extend a CSR (off, order) built over edges [0, e0) to cover all of
    `keys` (len E >= e0).  Appended edge ids are larger than every old id,
    so stability by (key, edge id) is preserved by placing old entries
    first within each bucket; everything is O(E) gathers/scatters plus a
    sort of only the appended tail."""
    E = len(keys)
    add = keys[e0:]
    add_order = np.argsort(add, kind="stable").astype(np.int64)
    add_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(add, minlength=n), out=add_off[1:])
    new_off = off + add_off

    out = np.empty(E, dtype=np.int64)
    v_old = keys[order]
    out[new_off[v_old] + (np.arange(e0, dtype=np.int64) - off[v_old])] = order
    va = add[add_order]
    old_cnt = off[va + 1] - off[va]
    out[
        new_off[va]
        + old_cnt
        + (np.arange(E - e0, dtype=np.int64) - add_off[va])
    ] = add_order + e0
    return new_off, out


class Bigraph:
    """Edge-centric bidirected multigraph over int32 arrays."""

    def __init__(self, n_nodes: int, mirror_node: np.ndarray) -> None:
        assert mirror_node.shape == (n_nodes,)
        self.n_nodes = int(n_nodes)
        self.mirror_node = mirror_node.astype(np.int32)
        cap = 16
        self._n_edges = 0
        self.edge_src = np.zeros(cap, dtype=np.int32)
        self.edge_dst = np.zeros(cap, dtype=np.int32)
        self.edge_weight = np.zeros(cap, dtype=np.int64)
        self.edge_handle = np.full(cap, -1, dtype=np.int64)
        self.edge_forward = np.zeros(cap, dtype=bool)
        self.edge_dummy_id = np.zeros(cap, dtype=np.int64)  # 0 = original
        self._csr_cache: tuple | None = None
        # (edge_count, out_degrees, in_degrees): degrees are recomputed
        # incrementally over the appended edge tail (edges are append-only),
        # so the repeated imbalance scans of a pipeline run (unbalanced
        # scan, balancer, Eulerian precondition) cost one bincount over the
        # new dummies instead of three over all edges.  Cached arrays are
        # immutable (extension allocates new ones), so copies share them.
        self._deg_cache: tuple | None = None
        self._sm_cache: np.ndarray | None = None

    # -- construction -----------------------------------------------------

    @property
    def n_edges(self) -> int:
        return self._n_edges

    def _reserve(self, extra: int) -> None:
        need = self._n_edges + extra
        cap = len(self.edge_src)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in (
            "edge_src",
            "edge_dst",
            "edge_weight",
            "edge_handle",
            "edge_forward",
            "edge_dummy_id",
        ):
            old = getattr(self, name)
            new = np.zeros(new_cap, dtype=old.dtype)
            new[: self._n_edges] = old[: self._n_edges]
            if name == "edge_handle":
                new[self._n_edges :] = -1
            setattr(self, name, new)

    def add_biedge_pair(
        self,
        src: int,
        dst: int,
        weight: int,
        handle: int,
        forward: bool,
        dummy_id: int,
    ) -> int:
        """Add edge (src,dst) and its mirror (mirror dst, mirror src).

        Returns the forward edge id; the mirror edge id is that ^ 1.
        """
        self._reserve(2)
        e = self._n_edges
        m = self.mirror_node
        self.edge_src[e] = src
        self.edge_dst[e] = dst
        self.edge_src[e + 1] = m[dst]
        self.edge_dst[e + 1] = m[src]
        self.edge_weight[e : e + 2] = weight
        self.edge_handle[e : e + 2] = handle
        self.edge_forward[e] = forward
        self.edge_forward[e + 1] = not forward
        self.edge_dummy_id[e : e + 2] = dummy_id
        self._n_edges += 2
        return e

    def add_biedge_pairs(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: np.ndarray,
        handle: np.ndarray,
        forward: np.ndarray,
        dummy_id: np.ndarray,
    ) -> np.ndarray:
        """Vectorized bulk version of :meth:`add_biedge_pair`."""
        n = len(src)
        self._reserve(2 * n)
        e0 = self._n_edges
        m = self.mirror_node
        fwd = np.arange(e0, e0 + 2 * n, 2)
        bwd = fwd + 1
        self.edge_src[fwd] = src
        self.edge_dst[fwd] = dst
        self.edge_src[bwd] = m[dst]
        self.edge_dst[bwd] = m[src]
        self.edge_weight[fwd] = weight
        self.edge_weight[bwd] = weight
        self.edge_handle[fwd] = handle
        self.edge_handle[bwd] = handle
        self.edge_forward[fwd] = forward
        self.edge_forward[bwd] = ~np.asarray(forward, dtype=bool)
        self.edge_dummy_id[fwd] = dummy_id
        self.edge_dummy_id[bwd] = dummy_id
        self._n_edges += 2 * n
        return fwd

    # -- views ------------------------------------------------------------

    def srcs(self) -> np.ndarray:
        return self.edge_src[: self._n_edges]

    def dsts(self) -> np.ndarray:
        return self.edge_dst[: self._n_edges]

    def weights(self) -> np.ndarray:
        return self.edge_weight[: self._n_edges]

    def handles(self) -> np.ndarray:
        return self.edge_handle[: self._n_edges]

    def forwards(self) -> np.ndarray:
        return self.edge_forward[: self._n_edges]

    def dummy_ids(self) -> np.ndarray:
        return self.edge_dummy_id[: self._n_edges]

    def is_dummy(self) -> np.ndarray:
        return self.dummy_ids() != 0

    @staticmethod
    def mirror_edge(e: int | np.ndarray):
        return e ^ 1

    def is_self_mirror_node(self, v: int) -> bool:
        return self.mirror_node[v] == v

    def self_mirror_mask(self) -> np.ndarray:
        if self._sm_cache is None:
            self._sm_cache = self.mirror_node == np.arange(
                self.n_nodes, dtype=np.int32
            )
        return self._sm_cache

    # -- degrees / imbalance ----------------------------------------------

    def _degrees(self):
        """(out_degrees, in_degrees), cached per edge count (see __init__)."""
        E = self._n_edges
        cache = self._deg_cache
        if cache is not None and cache[0] == E:
            return cache[1], cache[2]
        if cache is not None and cache[0] < E:
            e0, out, inn = cache
            out = out + np.bincount(
                self.edge_src[e0:E], minlength=self.n_nodes
            )
            inn = inn + np.bincount(
                self.edge_dst[e0:E], minlength=self.n_nodes
            )
        else:
            out = np.bincount(self.srcs(), minlength=self.n_nodes).astype(
                np.int64
            )
            inn = np.bincount(self.dsts(), minlength=self.n_nodes).astype(
                np.int64
            )
        self._deg_cache = (E, out, inn)
        return out, inn

    def out_degrees(self) -> np.ndarray:
        return self._degrees()[0]

    def in_degrees(self) -> np.ndarray:
        return self._degrees()[1]

    def imbalances(self) -> np.ndarray:
        """Per-node Eulerian imbalance, vectorized.

        Mirrors ``compute_eulerian_superfluous_out_biedges`` for every node:
        outdeg - indeg for ordinary nodes, outdeg mod 2 for self-mirrors.
        Returns a fresh array (degrees are cached; callers may mutate).
        """
        out, inn = self._degrees()
        diff = out - inn
        sm = self.self_mirror_mask()
        diff[sm] = out[sm] % 2
        return diff

    # -- adjacency ---------------------------------------------------------

    def csr(self):
        """(out_offsets, out_edges, in_offsets, in_edges), edge ids sorted
        by (endpoint, edge id)."""
        return (*self.out_csr(), *self.in_csr())

    def out_csr(self):
        """(out_offsets, out_edges); the in side is built lazily on demand
        (each side is an O(E) stable sort — callers like the Eulerian
        decomposition only ever touch the out side).

        Edges are append-only, so a CSR built for an earlier edge count is
        extended incrementally: only the appended tail is sorted and the
        old entries move by vectorized gather/scatter — the post-balance
        re-sort of all ~19M edges cost ~2s at 60M bases."""
        return self._csr("out", self.srcs)

    def in_csr(self):
        """(in_offsets, in_edges); see out_csr."""
        return self._csr("in", self.dsts)

    def _csr(self, side: str, keys_fn):
        if self._csr_cache is None:
            self._csr_cache = {}
        E = self._n_edges
        cached = self._csr_cache.get(side)
        if cached is not None:
            e0, off, order = cached
            if e0 == E:
                return off, order
            if e0 < E:
                off, order = _extend_csr(off, order, keys_fn(), e0, self.n_nodes)
                self._csr_cache[side] = (E, off, order)
                return off, order
        n = self.n_nodes
        keys = keys_fn()
        from ..utils.sorting import stable_order

        order = stable_order(keys, n)
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(keys, minlength=n), out=off[1:])
        self._csr_cache[side] = (E, off, order)
        return off, order

    def out_edges_of(self, v: int) -> np.ndarray:
        out_off, out_edges = self.out_csr()
        return out_edges[out_off[v] : out_off[v + 1]]

    def in_edges_of(self, v: int) -> np.ndarray:
        in_off, in_edges = self.in_csr()
        return in_edges[in_off[v] : in_off[v + 1]]

    # -- invariants (reference's debug asserts, §4 of SURVEY.md) ----------

    def verify_node_pairing(self) -> bool:
        m = self.mirror_node
        return bool(np.all(m[m] == np.arange(self.n_nodes, dtype=np.int32)))

    def verify_edge_mirror_property(self) -> bool:
        """Every edge's partner (e^1) must be its structural mirror."""
        e = np.arange(self._n_edges)
        p = e ^ 1
        m = self.mirror_node
        ok = (
            np.all(self.srcs()[p] == m[self.dsts()[e]])
            and np.all(self.dsts()[p] == m[self.srcs()[e]])
            and np.all(self.weights()[p] == self.weights()[e])
            and np.all(self.handles()[p] == self.handles()[e])
            and np.all(self.dummy_ids()[p] == self.dummy_ids()[e])
        )
        return bool(ok)

    def copy(self) -> "Bigraph":
        g = Bigraph(self.n_nodes, self.mirror_node.copy())
        g._n_edges = self._n_edges
        g.edge_src = self.edge_src.copy()
        g.edge_dst = self.edge_dst.copy()
        g.edge_weight = self.edge_weight.copy()
        g.edge_handle = self.edge_handle.copy()
        g.edge_forward = self.edge_forward.copy()
        g.edge_dummy_id = self.edge_dummy_id.copy()
        # The packed device adjacency is immutable once built and its cache
        # key includes the edge count, so a copy can share it: any mutation
        # (added dummy edges) changes n_edges and misses the key check.
        cache = getattr(self, "_device_graph_cache", None)
        if cache is not None:
            g._device_graph_cache = cache
        # CSR entries are immutable (extension builds new arrays), so a
        # copy can share them; only the dict itself must be private.
        if self._csr_cache is not None:
            g._csr_cache = dict(self._csr_cache)
        # Degree-cache arrays are likewise immutable (incremental extension
        # allocates fresh arrays), so sharing the tuple is safe.
        g._deg_cache = self._deg_cache
        g._sm_cache = self._sm_cache
        return g
