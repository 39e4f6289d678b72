"""Deterministic PMML fixture generators for the port's paths.

A copy of ``flink_jpmml_tpu/assets_gen.py`` — the five BASELINE
configurations (``gen_iris_lr``, ``gen_gbm``, ``gen_mlp``, ``gen_kmeans``,
``gen_stacked`` with its ``wide_lr`` stage), the negative fixtures and
``generate_all`` — so that ``chip_smoke.py`` and the port's tests can write
them with no JAX package present; for the same arguments it writes bytes
identical to the JAX package's generator (tests/test_torch_chain.py).
``_gen_tree_nodes`` takes one more keyword, ``leaf_score``, for
``gen_vote_forest``: the classification forest of the GBM's shape, which
the JAX package has no generator for. Seeded: every run writes
byte-identical documents.
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
# Config 1: Iris logistic regression
# ---------------------------------------------------------------------------

IRIS_FIELDS = ("sepal_length", "sepal_width", "petal_length", "petal_width")
IRIS_CLASSES = ("setosa", "versicolor", "virginica")


def gen_iris_lr(out_dir: str, seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    root = _pmml_root()
    _data_dictionary(root, IRIS_FIELDS, "species", IRIS_CLASSES)
    model = ET.SubElement(
        root,
        "RegressionModel",
        {
            "modelName": "iris-lr",
            "functionName": "classification",
            "normalizationMethod": "softmax",
        },
    )
    _mining_schema(model, IRIS_FIELDS, "species")
    coefs = rng.normal(0.0, 1.0, size=(len(IRIS_CLASSES), len(IRIS_FIELDS)))
    intercepts = rng.normal(0.0, 0.5, size=len(IRIS_CLASSES))
    for ci, cls in enumerate(IRIS_CLASSES):
        table = ET.SubElement(
            model,
            "RegressionTable",
            {"intercept": _fmt(intercepts[ci]), "targetCategory": cls},
        )
        for fi, f in enumerate(IRIS_FIELDS):
            ET.SubElement(
                table,
                "NumericPredictor",
                {"name": f, "coefficient": _fmt(coefs[ci, fi])},
            )
    return _write(root, os.path.join(out_dir, "iris_lr.pmml"))


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


# ---------------------------------------------------------------------------
# Config 3: MLP NeuralNetwork
# ---------------------------------------------------------------------------


def gen_mlp(
    out_dir: str,
    n_inputs: int = 784,
    hidden: tuple = (256,),
    n_classes: int = 10,
    seed: int = 13,
    name: str | None = None,
) -> str:
    rng = np.random.default_rng(seed)
    fields = tuple(f"x{i}" for i in range(n_inputs))
    classes = tuple(str(c) for c in range(n_classes))
    root = _pmml_root()
    _data_dictionary(root, fields, "digit", classes)
    nn = ET.SubElement(
        root,
        "NeuralNetwork",
        {
            "modelName": "mlp",
            "functionName": "classification",
            "activationFunction": "rectifier",
            "normalizationMethod": "softmax",
        },
    )
    _mining_schema(nn, fields, "digit")
    inputs = ET.SubElement(nn, "NeuralInputs")
    for i, f in enumerate(fields):
        ni = ET.SubElement(inputs, "NeuralInput", {"id": f"in{i}"})
        df = ET.SubElement(
            ni, "DerivedField", {"optype": "continuous", "dataType": "double"}
        )
        ET.SubElement(df, "FieldRef", {"field": f})
    prev_ids = [f"in{i}" for i in range(n_inputs)]
    sizes = list(hidden) + [n_classes]
    for li, width in enumerate(sizes):
        is_output = li == len(sizes) - 1
        attrs = {}
        if is_output:
            attrs["activationFunction"] = "identity"
        layer = ET.SubElement(nn, "NeuralLayer", attrs)
        scale = 1.0 / np.sqrt(len(prev_ids))
        w = rng.normal(0.0, scale, size=(width, len(prev_ids)))
        b = rng.normal(0.0, 0.1, size=width)
        ids = []
        for j in range(width):
            nid = f"l{li}n{j}"
            neuron = ET.SubElement(
                layer, "Neuron", {"id": nid, "bias": _fmt(b[j])}
            )
            for k, src in enumerate(prev_ids):
                ET.SubElement(
                    neuron, "Con", {"from": src, "weight": _fmt(w[j, k])}
                )
            ids.append(nid)
        prev_ids = ids
    outs = ET.SubElement(nn, "NeuralOutputs")
    for j, cls in enumerate(classes):
        no = ET.SubElement(outs, "NeuralOutput", {"outputNeuron": prev_ids[j]})
        df = ET.SubElement(
            no, "DerivedField", {"optype": "categorical", "dataType": "string"}
        )
        ET.SubElement(df, "NormDiscrete", {"field": "digit", "value": cls})
    fname = name or f"mlp_{n_inputs}x{'x'.join(map(str, hidden))}x{n_classes}.pmml"
    return _write(root, os.path.join(out_dir, fname))


# ---------------------------------------------------------------------------
# Config 4: K-Means clustering
# ---------------------------------------------------------------------------


def gen_kmeans(
    out_dir: str, k: int = 5, n_features: int = 4, seed: int = 17
) -> str:
    rng = np.random.default_rng(seed)
    fields = tuple(f"f{i}" for i in range(n_features))
    root = _pmml_root()
    _data_dictionary(root, fields)
    cm = ET.SubElement(
        root,
        "ClusteringModel",
        {
            "modelName": "kmeans",
            "functionName": "clustering",
            "modelClass": "centerBased",
            "numberOfClusters": str(k),
        },
    )
    _mining_schema(cm, fields)
    measure = ET.SubElement(cm, "ComparisonMeasure", {"kind": "distance"})
    ET.SubElement(measure, "squaredEuclidean")
    for f in fields:
        ET.SubElement(cm, "ClusteringField", {"field": f})
    centers = rng.normal(0.0, 2.0, size=(k, n_features))
    for ci in range(k):
        cl = ET.SubElement(
            cm, "Cluster", {"id": str(ci + 1), "name": f"cluster-{ci + 1}"}
        )
        arr = ET.SubElement(
            cl, "Array", {"n": str(n_features), "type": "real"}
        )
        arr.text = " ".join(_fmt(v) for v in centers[ci])
    return _write(root, os.path.join(out_dir, "kmeans.pmml"))


# ---------------------------------------------------------------------------
# Config 5: stacked modelChain — GBM → logistic calibration
# ---------------------------------------------------------------------------


def gen_stacked(
    out_dir: str,
    n_trees: int = 50,
    depth: int = 4,
    n_features: int = 64,
    seed: int = 23,
    name: str = "stacked.pmml",
    wide_lr: bool = False,
) -> str:
    """Config 5's stacked modelChain. ``wide_lr=True`` is the full
    BASELINE shape — "GBM + LR calibration, 10k-dim sparse features,
    sharded": an extra chain stage scores a linear model over ALL raw
    features (one [F]-wide coefficient vector — the tensor
    ``mesh_sharded`` feature-shards over the ``model`` axis), and the
    final calibration combines gbm_score + lr_score."""
    rng = np.random.default_rng(seed)
    fields = tuple(f"f{i}" for i in range(n_features))
    root = _pmml_root()
    _data_dictionary(root, fields)
    outer = ET.SubElement(
        root,
        "MiningModel",
        {"modelName": "stacked", "functionName": "regression"},
    )
    _mining_schema(outer, fields)
    seg = ET.SubElement(outer, "Segmentation", {"multipleModelMethod": "modelChain"})

    # Segment 1: inner GBM (MiningModel sum of trees) exporting gbm_score
    s1 = ET.SubElement(seg, "Segment", {"id": "gbm"})
    ET.SubElement(s1, "True")
    inner = ET.SubElement(
        s1, "MiningModel", {"functionName": "regression", "modelName": "inner-gbm"}
    )
    out1 = ET.SubElement(inner, "Output")
    ET.SubElement(
        out1,
        "OutputField",
        {"name": "gbm_score", "feature": "predictedValue"},
    )
    _mining_schema(inner, fields)
    iseg = ET.SubElement(inner, "Segmentation", {"multipleModelMethod": "sum"})
    for t in range(n_trees):
        st = ET.SubElement(iseg, "Segment", {"id": f"t{t}"})
        ET.SubElement(st, "True")
        tree = ET.SubElement(
            st,
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
        _gen_tree_nodes(root_node, rng, n_features, depth, _counter(), 0.2)

    if wide_lr:
        # Segment 2: the wide linear stage — every raw feature carries a
        # small coefficient (the 10k-dim sparse LR of config 5)
        sw = ET.SubElement(seg, "Segment", {"id": "wide-lr"})
        ET.SubElement(sw, "True")
        wlr = ET.SubElement(
            sw,
            "RegressionModel",
            {"functionName": "regression", "modelName": "wide-lr"},
        )
        outw = ET.SubElement(wlr, "Output")
        ET.SubElement(
            outw,
            "OutputField",
            {"name": "lr_score", "feature": "predictedValue"},
        )
        _mining_schema(wlr, fields)
        wtable = ET.SubElement(
            wlr, "RegressionTable", {"intercept": _fmt(0.05)}
        )
        coefs = rng.normal(0.0, 0.02, size=n_features)
        for f, c in zip(fields, coefs):
            ET.SubElement(
                wtable,
                "NumericPredictor",
                {"name": f, "coefficient": _fmt(c)},
            )

    # Final segment: logistic calibration over the chained scores
    s2 = ET.SubElement(seg, "Segment", {"id": "calibrate"})
    ET.SubElement(s2, "True")
    lr = ET.SubElement(
        s2,
        "RegressionModel",
        {
            "functionName": "regression",
            "normalizationMethod": "logit",
            "modelName": "calibration",
        },
    )
    ms = ET.SubElement(lr, "MiningSchema")
    ET.SubElement(ms, "MiningField", {"name": "gbm_score", "usageType": "active"})
    table = ET.SubElement(lr, "RegressionTable", {"intercept": _fmt(-0.3)})
    ET.SubElement(
        table,
        "NumericPredictor",
        {"name": "gbm_score", "coefficient": _fmt(1.7)},
    )
    if wide_lr:
        ET.SubElement(ms, "MiningField", {"name": "lr_score", "usageType": "active"})
        ET.SubElement(
            table,
            "NumericPredictor",
            {"name": "lr_score", "coefficient": _fmt(0.9)},
        )
    return _write(root, os.path.join(out_dir, name))


# ---------------------------------------------------------------------------
# Negative fixtures + entry point
# ---------------------------------------------------------------------------


def gen_negative(out_dir: str) -> None:
    with open(os.path.join(out_dir, "malformed.pmml"), "w") as f:
        f.write('<?xml version="1.0"?><PMML version="4.3"><DataDictionary>')
    with open(os.path.join(out_dir, "unsupported_version.pmml"), "w") as f:
        f.write(
            '<?xml version="1.0"?><PMML xmlns="http://www.dmg.org/PMML-3_2" '
            'version="3.2"><DataDictionary/></PMML>'
        )
    with open(os.path.join(out_dir, "no_model.pmml"), "w") as f:
        f.write(
            f'<?xml version="1.0"?><PMML xmlns="{XMLNS}" version="4.3">'
            "<DataDictionary/></PMML>"
        )


def generate_all(out_dir: str, small: bool = True) -> dict:
    """Write the standard fixture set; ``small=True`` keeps tests fast
    (tiny GBM/MLP); bench generates its own full-size models."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "iris_lr": gen_iris_lr(out_dir),
        "kmeans": gen_kmeans(out_dir),
        "stacked": gen_stacked(out_dir, n_trees=8, depth=3, n_features=12),
    }
    if small:
        paths["gbm"] = gen_gbm(out_dir, n_trees=16, depth=4, n_features=8,
                               name="gbm_small.pmml")
        paths["mlp"] = gen_mlp(out_dir, n_inputs=8, hidden=(16,), n_classes=3,
                               name="mlp_small.pmml")
    else:
        paths["gbm"] = gen_gbm(out_dir, n_trees=500, depth=6, n_features=32)
        paths["mlp"] = gen_mlp(out_dir)
    gen_negative(out_dir)
    return paths
