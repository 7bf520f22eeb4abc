"""TensorTree BSDF XML loader (Radiance tensor tree format).

Parses the WindowElement XML with IncidentDataStructure TensorTree3/4
(reference: src/runtime/measured/TensorTreeLoader.cpp): the {}-nested
scattering data becomes a python tree, which is then BAKED into a dense
regular grid over the Shirley-Chiu parameter square(s) at resolution
2^maxdepth (capped). The reference walks the tree per lane at shading time
(tensortree.art tt_climb_tree) — a data-dependent loop; here a dense
nearest-cell gather is exact for the same piecewise-constant function as
long as the bake resolution reaches the deepest leaf.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, NamedTuple, Optional, Union

import numpy as np


def _parse_xml(path):
    """Parse the XML with any namespace stripped (LBNL files declare
    xmlns="http://windows.lbl.gov")."""
    it = ET.iterparse(str(path))
    for _, el in it:
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return it.root


class TTNode(NamedTuple):
    children: list   # list[TTNode], empty for leaves
    values: list     # list[float]: 1 (uniform) or 2^ndim


class TensorTreeComponentNp(NamedTuple):
    grid: np.ndarray     # ndim-dimensional dense bake, res^ndim
    total: float
    # reference TensorTreeLoader.h:107: pi / 4^maxDepth (peak extraction)
    min_proj_sa: float


class TensorTreeNp(NamedTuple):
    ndim: int
    front_reflection: TensorTreeComponentNp
    back_reflection: TensorTreeComponentNp
    front_transmission: TensorTreeComponentNp
    back_transmission: TensorTreeComponentNp


def _parse_tree(text: str, ndim: int) -> TTNode:
    cap = 1 << ndim
    root = TTNode([], [])
    stack = [root]
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "{":
            node = TTNode([], [])
            stack[-1].children.append(node)
            stack.append(node)
            i += 1
        elif c == "}":
            stack.pop()
            i += 1
        elif c in ", \t\r\n":
            i += 1
        else:
            j = i
            while j < n and text[j] not in ",{} \t\r\n":
                j += 1
            stack[-1].values.append(abs(float(text[i:j])))
            i = j
    if len(root.children) == 1 and not root.values:
        root = root.children[0]
    return root


def _compute_total(node: TTNode, depth: int = 1) -> float:
    """Reference TensorTreeLoader.h computeTotal: the component 'total'
    used for lobe-selection probabilities. The reference weights each
    value by 1/(depth * fanout) (NOT the true cell measure); matched
    exactly so refl_prob — and therefore sampling/MIS noise — agrees."""
    area = 1.0 / (depth * (len(node.values) + len(node.children)))
    total = sum(_compute_total(c, depth + 1) for c in node.children)
    total += sum(np.pi * v * area for v in node.values)
    return total


def _max_depth(node: TTNode, d=0) -> int:
    if not node.children:
        # a full-value leaf subdivides each axis once more
        return d + (1 if len(node.values) > 1 else 0)
    return max(_max_depth(c, d + 1) for c in node.children)


def _ref_max_depth(node: TTNode, d=1) -> int:
    """Reference computeMaxDepth(1) convention (TensorTreeLoader.h): root
    counts as depth 1, leaves return their node depth (no extra level for
    full-value leaves). Drives min_proj_sa = pi/4^depth only."""
    if not node.children:
        return d
    return max(_ref_max_depth(c, d + 1) for c in node.children)


def _bake(node: TTNode, grid: np.ndarray, ndim: int):
    """Fill `grid` (a res^ndim view) with the tree's piecewise-constant
    function. Child octant bit j <-> axis j upper half
    (tensortree.art tt_lookup_grid); full-leaf cell bit (ndim-1-j) <-> axis
    j upper half (tt_lookup_leaf iterates axes in reverse)."""
    def axis_slices(idx_bits, bit_of_axis):
        sl = []
        for ax in range(ndim):
            half = grid.shape[ax] // 2
            up = (idx_bits >> bit_of_axis(ax)) & 1
            sl.append(slice(half, None) if up else slice(0, half))
        return tuple(sl)

    if not node.children:
        if len(node.values) == 1:
            grid[...] = node.values[0]
        else:
            for cell in range(1 << ndim):
                v = node.values[cell]
                grid[axis_slices(cell, lambda ax: ndim - 1 - ax)] = v
        return
    for oct_i, child in enumerate(node.children):
        _bake(child, grid[axis_slices(oct_i, lambda ax: ax)], ndim)


def _component(node: Optional[TTNode], ndim: int,
               max_res: int) -> TensorTreeComponentNp:
    if node is None:
        return TensorTreeComponentNp(np.zeros((1,) * ndim, np.float32), 0.0,
                                     float(np.pi))
    depth = max(_max_depth(node), 1)
    cap = 6 if ndim == 4 else 8
    res = 1 << min(depth, cap, max_res.bit_length() - 1)
    grid = np.zeros((res,) * ndim, np.float32)
    _bake(node, grid, ndim)
    rd = _ref_max_depth(node)
    min_proj_sa = float(np.pi / float((1 << rd) * (1 << rd)))
    return TensorTreeComponentNp(grid, float(_compute_total(node)),
                                 min_proj_sa)


def eval_tree_direct(node: TTNode, pos, ndim: int) -> float:
    """CPU oracle: walk the parsed tree exactly like the reference kernel
    (tensortree.art tt_climb_tree + tt_lookup_grid + tt_lookup_leaf) at
    parameter point `pos` in [0,1)^ndim. Used by tests to certify the
    dense bake reproduces the tree's piecewise-constant function."""
    pos = list(pos)
    while node.children:
        n = 0
        for ax in range(ndim):
            p = 2.0 * pos[ax]
            t = 1 if p >= 1.0 else 0
            n |= t << ax
            pos[ax] = p - t
        node = node.children[n]
    if len(node.values) == 1:
        return node.values[0]
    n = 0
    t = 0
    for ax in reversed(range(ndim)):
        n += int(2.0 * pos[ax]) << t
        t += 1
    return node.values[n]


def load_tensortree_raw(path):
    """Parse the XML and return (ndim, {component: TTNode}) without baking —
    the direct-walk oracle's input (tests only)."""
    doc = _parse_xml(path)
    layer = doc.find("Optical/Layer")
    struct = (layer.findtext("DataDefinition/IncidentDataStructure")
              or "").strip()
    ndim = 4 if struct == "TensorTree4" else 3
    trees = {}
    for data in layer.findall("WavelengthData"):
        if (data.findtext("Wavelength") or "").strip() != "Visible":
            continue
        block = data.find("WavelengthDataBlock")
        if block is None:
            continue
        tree = _parse_tree(block.findtext("ScatteringData") or "", ndim)
        direction = (block.findtext("WavelengthDataDirection") or "").strip()
        if direction == "Transmission Front":
            trees["back_transmission"] = tree
        elif direction in ("Scattering Back", "Reflection Back"):
            trees["front_reflection"] = tree
        elif direction == "Transmission Back":
            trees["front_transmission"] = tree
        else:
            trees["back_reflection"] = tree
    return ndim, trees


def load_tensortree(path, max_res: int = 256) -> TensorTreeNp:
    doc = _parse_xml(path)
    layer = doc.find("Optical/Layer")
    if layer is None:
        raise ValueError(f"{path}: no Optical/Layer")
    struct = (layer.findtext("DataDefinition/IncidentDataStructure")
              or "").strip()
    if struct == "TensorTree4":
        ndim = 4
    elif struct == "TensorTree3":
        ndim = 3
    else:
        raise ValueError(f"{path}: IncidentDataStructure '{struct}'")

    trees = {}
    for data in layer.findall("WavelengthData"):
        if (data.findtext("Wavelength") or "").strip() != "Visible":
            continue
        block = data.find("WavelengthDataBlock")
        if block is None:
            continue
        basis = (block.findtext("AngleBasis") or "").strip()
        if basis != "LBNL/Shirley-Chiu":
            raise ValueError(f"{path}: AngleBasis '{basis}'")
        tree = _parse_tree(block.findtext("ScatteringData") or "", ndim)
        direction = (block.findtext("WavelengthDataDirection") or "").strip()
        # front/back window-convention flip (TensorTreeLoader.cpp:157)
        if direction == "Transmission Front":
            trees["back_transmission"] = tree
        elif direction in ("Scattering Back", "Reflection Back"):
            trees["front_reflection"] = tree
        elif direction == "Transmission Back":
            trees["front_transmission"] = tree
        else:
            trees["back_reflection"] = tree

    fr = _component(trees.get("front_reflection"), ndim, max_res)
    br = _component(trees.get("back_reflection"), ndim, max_res)
    ft = _component(trees.get("front_transmission"), ndim, max_res)
    bt = _component(trees.get("back_transmission"), ndim, max_res)
    if bt.total <= 1e-7 and ft.total > 0:
        bt = ft
    if ft.total <= 1e-7 and bt.total > 0:
        ft = bt
    return TensorTreeNp(ndim, fr, br, ft, bt)
