"""Deterministic PMML fixture generator for the GBM of BASELINE config 2.

A copy of ``gen_gbm`` and its helpers from ``flink_jpmml_tpu/assets_gen.py``,
so that ``chip_smoke.py`` and the port's tests can write the 500-tree GBM
with no JAX package present. Seeded: every run writes byte-identical
documents, identical to the JAX package's generator.
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
    parent, rng, n_features, depth, node_counter, value_scale, grids=None
):
    """Complete binary tree of the given depth under ``parent``: each split
    puts complementary (lessThan t, greaterOrEqual t) predicates on the two
    children; ``defaultChild`` points left; depth-1 children carry scores.

    ``grids`` (optional, [n_features, n_bins]) restricts each feature's
    thresholds to a fixed per-feature value grid, mirroring histogram-
    trained GBMs (LightGBM / XGBoost-hist bin boundaries)."""
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
            node.set("score", _fmt(rng.normal(0.0, value_scale)))
        else:
            _gen_tree_nodes(
                node, rng, n_features, depth - 1, node_counter, value_scale,
                grids,
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
