"""Deterministic PMML fixture generators for the port's tree-ensemble paths.

``gen_gbm`` and its helpers are a copy of ``flink_jpmml_tpu/assets_gen.py``,
so that ``chip_smoke.py`` and the port's tests can write the 500-tree GBM
of BASELINE config 2 with no JAX package present; it writes documents
identical to the JAX package's generator. ``gen_vote_forest`` writes the
classification forest of the same shape (majorityVote or
weightedMajorityVote), which the JAX package has no generator for.
Seeded: every run writes byte-identical documents.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

XMLNS = "http://www.dmg.org/PMML-4_3"
VERSION = "4.3"


def _pmml_root() -> ET.Element:
    root = ET.Element("PMML", {"xmlns": XMLNS, "version": VERSION})
    header = ET.SubElement(root, "Header", {"description": "flink_jpmml_tpu fixture"})
    ET.SubElement(header, "Application", {"name": "flink_jpmml_tpu.assets"})
    return root


def _data_dictionary(root: ET.Element, fields, target=None, target_values=()):
    dd = ET.SubElement(root, "DataDictionary")
    for name in fields:
        ET.SubElement(
            dd, "DataField", {"name": name, "optype": "continuous", "dataType": "double"}
        )
    if target is not None:
        tf = ET.SubElement(
            dd,
            "DataField",
            {"name": target, "optype": "categorical", "dataType": "string"},
        )
        for v in target_values:
            ET.SubElement(tf, "Value", {"value": v})
    return dd


def _mining_schema(model: ET.Element, fields, target=None):
    ms = ET.SubElement(model, "MiningSchema")
    if target is not None:
        ET.SubElement(ms, "MiningField", {"name": target, "usageType": "target"})
    for name in fields:
        ET.SubElement(ms, "MiningField", {"name": name, "usageType": "active"})
    return ms


def _write(root: ET.Element, path: str) -> str:
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)
    return path


def _fmt(x: float) -> str:
    return repr(float(np.float64(x)))


# ---------------------------------------------------------------------------
# Config 2: GBM — MiningModel sum of regression TreeModels
# ---------------------------------------------------------------------------


def _gen_tree_nodes(
    parent, rng, n_features, depth, node_counter, value_scale, grids=None,
    leaf_score=None,
):
    """Complete binary tree of the given depth under ``parent``: each split
    puts complementary (lessThan t, greaterOrEqual t) predicates on the two
    children; ``defaultChild`` points left; depth-1 children carry scores.

    ``grids`` (optional, [n_features, n_bins]) restricts each feature's
    thresholds to a fixed per-feature value grid, mirroring histogram-
    trained GBMs (LightGBM / XGBoost-hist bin boundaries). ``leaf_score``
    (optional, ``rng -> str``) draws a leaf's score attribute; the default
    is a regression value from N(0, ``value_scale``)."""
    if depth < 1:
        raise ValueError(f"tree depth must be >= 1, got {depth}")
    feat = int(rng.integers(0, n_features))
    if grids is not None:
        thr = float(grids[feat][int(rng.integers(0, len(grids[feat])))])
    else:
        thr = float(rng.normal(0.0, 1.0))
    left_id = str(next(node_counter))
    right_id = str(next(node_counter))
    for nid, op in ((left_id, "lessThan"), (right_id, "greaterOrEqual")):
        node = ET.SubElement(parent, "Node", {"id": nid})
        ET.SubElement(
            node,
            "SimplePredicate",
            {"field": f"f{feat}", "operator": op, "value": _fmt(thr)},
        )
        if depth == 1:
            node.set(
                "score",
                leaf_score(rng) if leaf_score is not None
                else _fmt(rng.normal(0.0, value_scale)),
            )
        else:
            _gen_tree_nodes(
                node, rng, n_features, depth - 1, node_counter, value_scale,
                grids, leaf_score,
            )
    parent.set("defaultChild", left_id)


def _counter():
    i = 0
    while True:
        yield i
        i += 1


def gen_gbm(
    out_dir: str,
    n_trees: int = 500,
    depth: int = 6,
    n_features: int = 32,
    seed: int = 11,
    base_score: float = 0.5,
    hist_bins: int | None = 254,
    name: str | None = None,
) -> str:
    """500-tree GBM fixture (BASELINE config 2).

    ``hist_bins`` (default 254) draws each feature's split thresholds from a
    fixed per-feature grid of that many values, like histogram-trained GBMs
    (LightGBM ``max_bin``/XGBoost ``tree_method=hist`` models, whose splits
    always land on bin boundaries). This keeps the model eligible for the
    uint8 rank wire (qtrees.py). ``hist_bins=None`` draws unrestricted
    continuous thresholds instead."""
    rng = np.random.default_rng(seed)
    grids = (
        np.sort(rng.normal(0.0, 1.0, size=(n_features, hist_bins)), axis=1)
        if hist_bins is not None
        else None
    )
    fields = tuple(f"f{i}" for i in range(n_features))
    root = _pmml_root()
    _data_dictionary(root, fields)
    mm = ET.SubElement(
        root,
        "MiningModel",
        {"modelName": f"gbm-{n_trees}", "functionName": "regression"},
    )
    _mining_schema(mm, fields)
    targets = ET.SubElement(mm, "Targets")
    ET.SubElement(targets, "Target", {"rescaleConstant": _fmt(base_score)})
    seg = ET.SubElement(mm, "Segmentation", {"multipleModelMethod": "sum"})
    for t in range(n_trees):
        s = ET.SubElement(seg, "Segment", {"id": str(t)})
        ET.SubElement(s, "True")
        tree = ET.SubElement(
            s,
            "TreeModel",
            {
                "functionName": "regression",
                "missingValueStrategy": "defaultChild",
                "splitCharacteristic": "binarySplit",
            },
        )
        _mining_schema(tree, fields)
        root_node = ET.SubElement(tree, "Node", {"id": "r"})
        ET.SubElement(root_node, "True")
        _gen_tree_nodes(
            root_node, rng, n_features, depth, _counter(), 0.1, grids
        )
    fname = name or f"gbm_{n_trees}.pmml"
    return _write(root, os.path.join(out_dir, fname))


def gen_vote_forest(
    out_dir: str,
    n_trees: int = 500,
    depth: int = 6,
    n_features: int = 32,
    n_classes: int = 3,
    weighted: bool = False,
    seed: int = 0,
    hist_bins: int | None = 254,
    name: str | None = None,
) -> str:
    """Classification vote forest of the GBM's shape: a MiningModel of
    ``n_trees`` complete classification TreeModels of the given depth,
    each leaf scoring a class label (``c0`` .. ``c{n_classes-1}``) drawn
    from the seed, over a categorical target ``y``.

    ``weighted=False`` combines the trees by ``majorityVote``;
    ``weighted=True`` by ``weightedMajorityVote`` with per-segment weights
    drawn from U(0.5, 2.0). ``hist_bins`` keeps thresholds on a per-feature
    grid as in :func:`gen_gbm`, so the forest stays on the uint8 rank
    wire."""
    if n_classes < 2:
        raise ValueError(f"a vote forest needs >= 2 classes, got {n_classes}")
    rng = np.random.default_rng(seed)
    grids = (
        np.sort(rng.normal(0.0, 1.0, size=(n_features, hist_bins)), axis=1)
        if hist_bins is not None
        else None
    )
    classes = tuple(f"c{k}" for k in range(n_classes))
    fields = tuple(f"f{i}" for i in range(n_features))
    root = _pmml_root()
    _data_dictionary(root, fields, target="y", target_values=classes)
    mm = ET.SubElement(
        root,
        "MiningModel",
        {"modelName": f"votes-{n_trees}", "functionName": "classification"},
    )
    _mining_schema(mm, fields, target="y")
    method = "weightedMajorityVote" if weighted else "majorityVote"
    seg = ET.SubElement(mm, "Segmentation", {"multipleModelMethod": method})

    def leaf_label(r):
        return classes[int(r.integers(0, n_classes))]

    for t in range(n_trees):
        attrs = {"id": str(t)}
        if weighted:
            attrs["weight"] = _fmt(rng.uniform(0.5, 2.0))
        s = ET.SubElement(seg, "Segment", attrs)
        ET.SubElement(s, "True")
        tree = ET.SubElement(
            s,
            "TreeModel",
            {
                "functionName": "classification",
                "missingValueStrategy": "defaultChild",
                "splitCharacteristic": "binarySplit",
            },
        )
        _mining_schema(tree, fields, target="y")
        root_node = ET.SubElement(tree, "Node", {"id": "r"})
        ET.SubElement(root_node, "True")
        _gen_tree_nodes(
            root_node, rng, n_features, depth, _counter(), 0.0, grids,
            leaf_label,
        )
    fname = name or (
        f"votes_{'w' if weighted else 'm'}{n_trees}_c{n_classes}.pmml"
    )
    return _write(root, os.path.join(out_dir, fname))
