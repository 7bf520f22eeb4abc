"""Host-side BVH build: binned SAH binary tree collapsed to BVH8 SoA.

Analog of the reference's madmann91/bvh-based build + N-ary collapse
(/root/reference/src/runtime/bvh/SceneBVHAdapter.h:110, NArityBvh.h), laid
out for traversal (ops/bvh.py, ops/bvh_gpu.py): node child bounds as
struct-of-arrays [n_nodes, 8], leaves as contiguous ranges of a reordered
triangle soup so leaf intersection is a short static loop over gathered
triangles.

Numpy only; runs at scene build. (A C++ builder can replace this for huge
scenes; the output layout stays.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 4      # max tris per leaf
N_BINS = 16
WIDTH = 8          # BVH arity


class BVH8(NamedTuple):
    """Flat BVH8. child index encoding: 0 = empty; > 0 = inner node index;
    < 0 = leaf: start = -(idx+1) >> 4, count = (-(idx+1)) & 15."""
    cmin_x: np.ndarray  # [n_nodes, 8]
    cmin_y: np.ndarray
    cmin_z: np.ndarray
    cmax_x: np.ndarray
    cmax_y: np.ndarray
    cmax_z: np.ndarray
    child: np.ndarray   # [n_nodes, 8] int32
    prim_order: np.ndarray  # [T] permutation applied to the soup


def _encode_leaf(start: int, count: int) -> int:
    return -((start << 4 | count) + 1)


def decode_leaf(code):
    v = -(code) - 1
    return v >> 4, v & 15


class _BuildNode:
    __slots__ = ("bb_min", "bb_max", "start", "count", "left", "right")

    def __init__(self):
        self.left = self.right = None
        self.start = self.count = 0


def build_bvh8(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BVH8:
    """v0/e1/e2: [T, 3] triangle soup (world space, padding excluded)."""
    t = len(v0)
    p1 = v0 + e1
    p2 = v0 + e2
    bb_min = np.minimum(np.minimum(v0, p1), p2)
    bb_max = np.maximum(np.maximum(v0, p1), p2)
    centers = (bb_min + bb_max) * 0.5

    order = np.arange(t)

    def half_area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return d[0] * (d[1] + d[2]) + d[1] * d[2]

    def build(idx):
        node = _BuildNode()
        node.bb_min = bb_min[idx].min(0)
        node.bb_max = bb_max[idx].max(0)
        if len(idx) <= LEAF_SIZE:
            node.start = idx
            node.count = len(idx)
            return node
        # binned SAH over the widest axis
        c = centers[idx]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            mid = len(idx) // 2
            node.left = build(idx[:mid])
            node.right = build(idx[mid:])
            return node
        lo = c[:, axis].min()
        scale = N_BINS * (1.0 - 1e-6) / max(ext[axis], 1e-30)
        bins = np.clip(((c[:, axis] - lo) * scale).astype(np.int32), 0,
                       N_BINS - 1)
        counts = np.bincount(bins, minlength=N_BINS)
        bmn = np.full((N_BINS, 3), np.inf)
        bmx = np.full((N_BINS, 3), -np.inf)
        for b in range(N_BINS):
            m = bins == b
            if m.any():
                bmn[b] = bb_min[idx[m]].min(0)
                bmx[b] = bb_max[idx[m]].max(0)
        # sweep SAH
        lmn = np.minimum.accumulate(bmn, 0)
        lmx = np.maximum.accumulate(bmx, 0)
        rmn = np.minimum.accumulate(bmn[::-1], 0)[::-1]
        rmx = np.maximum.accumulate(bmx[::-1], 0)[::-1]
        lcount = np.cumsum(counts)
        best_cost, best_split = np.inf, -1
        for split in range(1, N_BINS):
            nl = lcount[split - 1]
            nr = t_local - nl if False else len(idx) - nl
            if nl == 0 or nr == 0:
                continue
            cost = nl * half_area(lmn[split - 1], lmx[split - 1]) \
                + nr * half_area(rmn[split], rmx[split])
            if cost < best_cost:
                best_cost, best_split = cost, split
        if best_split < 0:
            mid = len(idx) // 2
            srt = idx[np.argsort(c[:, axis], kind="stable")]
            node.left = build(srt[:mid])
            node.right = build(srt[mid:])
            return node
        left_mask = bins < best_split
        node.left = build(idx[left_mask])
        node.right = build(idx[~left_mask])
        return node

    t_local = t
    if t == 0:
        z = np.zeros((1, WIDTH), np.float32)
        return BVH8(z, z, z, z, z, z, np.zeros((1, WIDTH), np.int32),
                    np.arange(0, dtype=np.int32))

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, old_limit))
    root = build(order)
    sys.setrecursionlimit(old_limit)

    # Collapse binary tree into BVH8: take up to 8 grandchildren greedily
    prim_order = []
    nodes = []  # list of dict(children=[(bb_min,bb_max,ref)...])

    def collect_wide(n, budget=WIDTH):
        """Split `n` into up to `budget` subtrees (largest-area first)."""
        subtrees = [n]
        while len(subtrees) < budget:
            # pick the inner subtree with the largest surface area
            cand = [s for s in subtrees if s.left is not None]
            if not cand:
                break
            pick = max(cand, key=lambda s: half_area(s.bb_min, s.bb_max))
            subtrees.remove(pick)
            subtrees += [pick.left, pick.right]
        return subtrees

    def emit(n) -> int:
        my_id = len(nodes)
        nodes.append(None)
        children = collect_wide(n)
        entries = []
        for ch in children:
            if ch.left is None:
                start = len(prim_order)
                prim_order.extend(ch.start.tolist())
                entries.append((ch.bb_min, ch.bb_max,
                                _encode_leaf(start, ch.count)))
            else:
                cid = emit(ch)
                entries.append((ch.bb_min, ch.bb_max, cid))
        nodes[my_id] = entries
        return my_id

    if root.left is None:
        # single-leaf scene
        start = 0
        prim_order = root.start.tolist()
        nodes.append([(root.bb_min, root.bb_max,
                       _encode_leaf(0, root.count))])
    else:
        emit(root)

    n_nodes = len(nodes)
    cmin = np.zeros((n_nodes, WIDTH, 3), np.float32)
    cmax = np.zeros((n_nodes, WIDTH, 3), np.float32)
    child = np.zeros((n_nodes, WIDTH), np.int32)
    cmin[:] = np.inf
    cmax[:] = -np.inf
    for i, entries in enumerate(nodes):
        for j, (mn, mx, ref) in enumerate(entries):
            cmin[i, j] = mn
            cmax[i, j] = mx
            child[i, j] = ref

    return BVH8(cmin[..., 0], cmin[..., 1], cmin[..., 2],
                cmax[..., 0], cmax[..., 1], cmax[..., 2],
                child, np.asarray(prim_order, np.int32))
