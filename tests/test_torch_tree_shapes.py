"""Every tree shape of the PyTorch port against the JAX package, on the
CPU: the iterative node-hop backend (trees deeper than
``max_dense_depth``; the halting strategies lastPrediction /
returnLastPrediction), the general scan (gtrees: compound and surrogate
predicates, n-ary nodes, isMissing, non-True roots), and the
weighted-path walk (wtrees: weightedConfidence / aggregateNodes).

Each case runs the same records through the JAX package's
``compile_pmml(doc).predict`` and ``score_records`` and the port's
(``device="cpu"``): validity equal, values and class rows within the
repo's bar (rtol 1e-4 / atol 1e-5), labels and empty lanes exactly equal;
and through the JAX oracle (``pmml/interp.evaluate``) at its golden
tolerance. The cases are those of tests/test_trees_extended.py,
tests/test_gtrees.py and tests/test_tree_halt.py, plus seeded N(0, 1.5)
rows with 20% missing cells, ``chip_smoke``'s tree generators at small
sizes, and the index edges a CUDA gather would trip on (padded child
slots, a missing ``defaultChild``, halts before any scored node).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_gtrees as jg
import test_tree_halt as jh
import test_trees_extended as je
from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.compile import prepare as jprepare
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu.utils.config import CompileConfig as JConfig
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.utils.config import CompileConfig as TConfig
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException
from test_torch_families import assert_predict_match

RTOL, ATOL = 1e-4, 1e-5  # port vs JAX package
GOLDEN = 2e-4  # port vs oracle (tests/test_trees_extended.py)


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def compile_both(xml, max_dense_depth=None):
    jkw, tkw = {}, {}
    if max_dense_depth is not None:
        jkw["config"] = JConfig(max_dense_depth=max_dense_depth)
        tkw["config"] = TConfig(max_dense_depth=max_dense_depth)
    return (jparse(xml), jcompile(jparse(xml), **jkw),
            compile_pmml(tparse(xml), device="cpu", **tkw))


def assert_records_match(jdoc, jm, tm, records):
    """``score_records`` of both packages and the oracle on ``records``."""
    jp, tp = jm.score_records(records), tm.score_records(records)
    for rec, a, b in zip(records, jp, tp):
        assert a.is_empty == b.is_empty, (rec, a, b)
        o = evaluate(jdoc, rec)
        assert o.is_missing == b.is_empty, (rec, o, b)
        if b.is_empty:
            continue
        assert b.score.value == pytest.approx(a.score.value, rel=RTOL,
                                              abs=ATOL), rec
        if o.value is not None:
            assert b.score.value == pytest.approx(o.value, rel=GOLDEN,
                                                  abs=ATOL), rec
        assert (a.target is None) == (b.target is None)
        if a.target is not None:
            assert b.target.label == a.target.label == o.label, rec
            for k, v in (a.target.probabilities or {}).items():
                assert b.target.probabilities[k] == pytest.approx(
                    v, rel=RTOL, abs=ATOL), (rec, k)
    X, M = jprepare.from_records(jm.field_space, records)
    assert_predict_match(jm, tm, X, M)


def seeded_rows(F, n=96, seed=0, missing=0.2):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    M = rng.random(size=X.shape) < missing
    X[M] = 0.0
    return X, M


def check(xml, records=(), max_dense_depth=None, seed=0):
    """One case: records through both packages and the oracle, then seeded
    rows with missing cells through both ``predict``s."""
    jdoc, jm, tm = compile_both(xml, max_dense_depth)
    if records:
        assert_records_match(jdoc, jm, tm, list(records))
    assert_predict_match(jm, tm, *seeded_rows(jm.field_space.arity,
                                              seed=seed))
    return jm, tm


def _gtree(body, strategy="none", ntc=None):
    ntc_attr = f' noTrueChildStrategy="{ntc}"' if ntc else ""
    return (f'{jg._HDR}<TreeModel functionName="regression" '
            f'missingValueStrategy="{strategy}"{ntc_attr}>{jg._SCHEMA}'
            f"{body}</TreeModel></PMML>")


def _halt_xml(strategy, ntc=None, interior_scores=True):
    s0 = ' score="0.5"' if interior_scores else ""
    s1 = ' score="0.7"' if interior_scores else ""
    ntc_attr = f' noTrueChildStrategy="{ntc}"' if ntc else ""
    return f"""<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
      <Header/><DataDictionary numberOfFields="3">
        <DataField name="a" optype="continuous" dataType="double"/>
        <DataField name="b" optype="continuous" dataType="double"/>
        <DataField name="y" optype="continuous" dataType="double"/>
      </DataDictionary>
      <TreeModel functionName="regression" missingValueStrategy="{strategy}"
                 splitCharacteristic="binarySplit"{ntc_attr}>
        <MiningSchema><MiningField name="y" usageType="target"/>
          <MiningField name="a"/><MiningField name="b"/></MiningSchema>
        <Node id="0"{s0}><True/>
          <Node id="1"{s1}>
            <SimplePredicate field="a" operator="lessThan" value="0"/>
            <Node id="3" score="1.0">
              <SimplePredicate field="b" operator="lessThan" value="0"/>
            </Node>
            <Node id="4" score="2.0">
              <SimplePredicate field="b" operator="greaterOrEqual" value="0"/>
            </Node>
          </Node>
          <Node id="2" score="3.0">
            <SimplePredicate field="a" operator="greaterOrEqual" value="0"/>
          </Node>
        </Node>
      </TreeModel></PMML>"""


def _chain_records(seed, n, fields=3):
    rng = np.random.default_rng(seed)
    return [{f"f{j}": float(rng.uniform(-0.2, 1.2)) for j in range(fields)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the iterative node-hop backend (TestIterativeBackend, TestSetPredicateSplits)
# ---------------------------------------------------------------------------


class TestNodeHop:
    def test_deep_tree_takes_the_node_hop_backend(self):
        jm, tm = check(je._deep_tree_xml(depth=14),
                       _chain_records(0, 128))
        assert {"col", "left", "right"} <= set(tm.params["model"])
        assert tm.params["model"]["left"].dtype == torch.int32

    def test_dense_and_iterative_agree(self, assets_dir):
        xml = (assets_dir / "gbm_small.pmml").read_text()
        rng = np.random.default_rng(1)
        X = rng.normal(0, 1, size=(64, 8)).astype(np.float32)
        M = X < -1.2  # some missing lanes (defaultChild path)
        X[M] = 0.0
        _, jm, tm = compile_both(xml, max_dense_depth=1)
        assert "col" in tm.params["model"]  # the node tables, not P
        assert_predict_match(jm, tm, X, M)  # node hop vs node hop
        assert_predict_match(jcompile(jparse(xml)), tm, X, M)  # vs dense

    def test_iterative_classification(self):
        xml = je._deep_tree_xml(depth=12).replace(
            'functionName="regression"', 'functionName="classification"')
        check(xml, _chain_records(2, 64))

    @pytest.mark.parametrize("max_dense_depth", [1, None],
                             ids=["node_hop", "dense"])
    def test_set_splits(self, max_dense_depth):
        recs = [{"color": "red", "x": -1.0}, {"color": "red", "x": 1.0},
                {"color": "blue", "x": 5.0}, {"color": "green", "x": 0.0},
                {"color": "black", "x": 0.0}, {"color": "purple", "x": 0.0},
                {"color": None, "x": 0.0}]
        check(je.SET_TREE, recs, max_dense_depth=max_dense_depth)

    def test_set_split_in_ensemble(self):
        seg = je.SET_TREE[je.SET_TREE.index("<TreeModel"):
                          je.SET_TREE.index("</PMML>")]
        xml = je.SET_TREE[:je.SET_TREE.index("<TreeModel")] + (
            '<MiningModel functionName="regression"><MiningSchema>'
            '<MiningField name="color"/><MiningField name="x"/>'
            '</MiningSchema><Segmentation multipleModelMethod="sum">'
            f"<Segment><True/>{seg}</Segment><Segment><True/>{seg}</Segment>"
            "</Segmentation></MiningModel></PMML>")
        recs = [{"color": "green", "x": 0.0}, {"color": "red", "x": 1.0},
                {"color": "red", "x": -1.0}]
        check(xml, recs, max_dense_depth=1)

    @pytest.mark.parametrize("strategy", ["defaultChild", "lastPrediction",
                                          "nullPrediction", "none"])
    def test_chip_smoke_deep_forest(self, strategy):
        # chip_smoke's deep_rf at a small size: every tree deeper than 10
        xml = cs.deep_rf_xml(n_trees=6, n_fields=5, max_leaves=40,
                             max_depth=16, min_depth=11, seed=3).replace(
            'missingValueStrategy="defaultChild"',
            f'missingValueStrategy="{strategy}"')
        jm, tm = check(xml, seed=4)
        assert tm.params["model"]["col"].shape[0] == 6
        X, M = seeded_rows(5, n=200, seed=9, missing=0.3)
        assert_predict_match(jm, tm, X, M)

    def test_with_strategy_equals_a_parsed_document(self):
        xml = cs.deep_rf_xml(n_trees=3, n_fields=4, max_leaves=30, seed=8)
        doc = cs.with_strategy(tparse(xml), "lastPrediction")
        ref = tparse(xml.replace('missingValueStrategy="defaultChild"',
                                 'missingValueStrategy="lastPrediction"'))
        assert doc == ref

    def test_default_child_routes_missing_values(self):
        # a missing value follows the node's defaultChild, left or right
        xml = cs.deep_rf_xml(n_trees=4, n_fields=3, max_leaves=24, seed=5)
        jdoc, jm, tm = compile_both(xml)
        X = np.zeros((2, 3), np.float32)
        M = np.array([[True, True, True], [False, True, False]])
        to = assert_predict_match(jm, tm, X, M)
        assert to.valid.all()


# ---------------------------------------------------------------------------
# halting strategies (tests/test_tree_halt.py TestLastPrediction)
# ---------------------------------------------------------------------------

HALT_RECORDS = jh.RECORDS + [{"a": 0.0, "b": 0.0}, {"a": -0.0}]


class TestHalts:
    @pytest.mark.parametrize("strategy,ntc,interior", [
        ("lastPrediction", None, True),
        ("lastPrediction", None, False),  # halts before any scored node
        ("none", "returnLastPrediction", True),
        ("none", "returnLastPrediction", False),
        ("none", "returnNullPrediction", True),
    ])
    def test_halt_strategies(self, strategy, ntc, interior):
        xml = _halt_xml(strategy, ntc, interior)
        jm, tm = check(xml, HALT_RECORDS)
        # the canonical forest takes the node hop (halts need it)
        if strategy == "lastPrediction":
            assert "halt" in tm.params["model"]

    def test_ensemble_of_halting_trees(self):
        tree = ('<TreeModel functionName="regression" '
                'missingValueStrategy="lastPrediction">'
                '<MiningSchema><MiningField name="a"/><MiningField name="b"/>'
                "</MiningSchema>"
                '<Node id="0" score="{r}"><True/>'
                '<Node id="1" score="{s}"><SimplePredicate field="{f}" '
                'operator="lessThan" value="{v}"/></Node>'
                '<Node id="2" score="{t}"><SimplePredicate field="{f}" '
                'operator="greaterOrEqual" value="{v}"/></Node>'
                "</Node></TreeModel>")
        xml = ('<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">'
               "<Header/><DataDictionary>"
               '<DataField name="a" optype="continuous" dataType="double"/>'
               '<DataField name="b" optype="continuous" dataType="double"/>'
               '</DataDictionary><MiningModel functionName="regression">'
               '<MiningSchema><MiningField name="a"/><MiningField name="b"/>'
               '</MiningSchema><Segmentation multipleModelMethod="sum">'
               "<Segment><True/>"
               + tree.format(r=0.25, s=1.5, t=-2.0, f="a", v=0)
               + "</Segment><Segment><True/>"
               + tree.format(r=0.75, s=4.0, t=8.0, f="b", v=1)
               + "</Segment></Segmentation></MiningModel></PMML>")
        check(xml, HALT_RECORDS)

    def test_halting_classification_with_distribution_only_interiors(self):
        xml = _halt_xml("lastPrediction").replace(
            'functionName="regression"', 'functionName="classification"')
        check(xml, HALT_RECORDS)

    def test_distribution_only_interior_regression_is_null_on_halt(self):
        # a dist-only interior is "scored" for the halt, its value null
        xml = _halt_xml("lastPrediction").replace(
            '<Node id="1" score="0.7">',
            '<Node id="1"><ScoreDistribution value="1" recordCount="3"/>')
        check(xml, HALT_RECORDS)


# ---------------------------------------------------------------------------
# the general scan (tests/test_gtrees.py, TestNestedCompoundPredicates)
# ---------------------------------------------------------------------------

_G = {
    "and_or": """<Node id="0"><True/>
      <Node id="1" score="1.0"><CompoundPredicate booleanOperator="and">
        <SimplePredicate field="a" operator="lessThan" value="0"/>
        <SimplePredicate field="b" operator="greaterOrEqual" value="0"/>
      </CompoundPredicate></Node>
      <Node id="2" score="2.0"><CompoundPredicate booleanOperator="or">
        <SimplePredicate field="a" operator="greaterOrEqual" value="1"/>
        <SimplePredicate field="c" operator="lessThan" value="0"/>
      </CompoundPredicate></Node>
      <Node id="3" score="3.0"><True/></Node></Node>""",
    "xor": """<Node id="0"><True/>
      <Node id="1" score="1.0"><CompoundPredicate booleanOperator="xor">
        <SimplePredicate field="a" operator="lessThan" value="0"/>
        <SimplePredicate field="b" operator="lessThan" value="0"/>
      </CompoundPredicate></Node>
      <Node id="2" score="2.0"><True/></Node></Node>""",
    "surrogate": """<Node id="0"><True/>
      <Node id="1" score="1.0"><CompoundPredicate booleanOperator="surrogate">
        <SimplePredicate field="a" operator="lessThan" value="0"/>
        <SimplePredicate field="b" operator="lessThan" value="0.25"/>
      </CompoundPredicate></Node>
      <Node id="2" score="2.0"><True/></Node></Node>""",
    "three_way": """<Node id="0"><True/>
      <Node id="1" score="1.0">
        <SimplePredicate field="a" operator="lessThan" value="-0.5"/></Node>
      <Node id="2" score="2.0">
        <SimplePredicate field="a" operator="lessThan" value="0.5"/></Node>
      <Node id="3" score="3.0"><True/></Node></Node>""",
    "is_missing": """<Node id="0"><True/>
      <Node id="1" score="1.0">
        <SimplePredicate field="a" operator="isMissing"/></Node>
      <Node id="2" score="2.0">
        <SimplePredicate field="a" operator="lessThan" value="0"/></Node>
      <Node id="3" score="3.0"><True/></Node></Node>""",
    "non_true_root": """<Node id="0">
      <SimplePredicate field="c" operator="greaterOrEqual" value="0"/>
      <Node id="1" score="1.0">
        <SimplePredicate field="a" operator="lessThan" value="0"/></Node>
      <Node id="2" score="2.0"><True/></Node></Node>""",
    "deeper_mixed": """<Node id="0"><True/>
      <Node id="1"><SimplePredicate field="a" operator="lessThan" value="0"/>
        <Node id="3" score="1.0"><CompoundPredicate booleanOperator="or">
          <SimplePredicate field="b" operator="lessThan" value="0"/>
          <SimplePredicate field="c" operator="greaterThan" value="1"/>
        </CompoundPredicate></Node>
        <Node id="4" score="2.0"><True/></Node></Node>
      <Node id="2"><True/>
        <Node id="5" score="3.0">
          <SimplePredicate field="b" operator="isNotMissing"/></Node>
        <Node id="6" score="4.0"><True/></Node></Node></Node>""",
    # a 2-child node in a tree of fan-out 3: its padded slot points at its
    # own row and must stay FALSE (tests/test_gtrees.py TestPaddedChildSlots)
    "padded_child_slots": """<Node id="0"><True/>
      <Node id="t3"><SimplePredicate field="a" operator="lessThan" value="0"/>
        <Node id="x1" score="1.0">
          <SimplePredicate field="b" operator="lessThan" value="-0.5"/></Node>
        <Node id="x2" score="2.0">
          <SimplePredicate field="b" operator="lessThan" value="0.5"/></Node>
        <Node id="x3" score="3.0"><True/></Node></Node>
      <Node id="t2"><True/>
        <Node id="y1" score="4.0">
          <SimplePredicate field="b" operator="lessThan" value="0"/></Node>
        <Node id="y2" score="5.0">
          <SimplePredicate field="b" operator="greaterOrEqual" value="1"/>
        </Node></Node></Node>""",
}

# a surrogate whose fields all miss leaves the scan to the strategy
_SURROGATE_SCORED = _G["surrogate"].replace('<Node id="0">',
                                            '<Node id="0" score="9.0">')

# defaultChild on a compound split; the second tree's inner node names no
# defaultChild, so a lane missing its fields nulls (dchild = −1, never
# followed)
_DEFAULT_CHILD = """<Node id="0" defaultChild="n2"><True/>
  <Node id="n1" score="1.0"><CompoundPredicate booleanOperator="and">
    <SimplePredicate field="a" operator="lessThan" value="0"/>
    <SimplePredicate field="b" operator="lessThan" value="0"/>
  </CompoundPredicate></Node>
  <Node id="n2" defaultChild="m1"><True/>
    <Node id="m1" score="2.0"><CompoundPredicate booleanOperator="or">
      <SimplePredicate field="c" operator="lessThan" value="0"/>
      <SimplePredicate field="a" operator="greaterThan" value="1"/>
    </CompoundPredicate></Node>
    <Node id="m2" score="3.0"><True/></Node>
    <Node id="m3"><SimplePredicate field="b" operator="isMissing"/>
      <Node id="k1" score="4.0">
        <SimplePredicate field="c" operator="greaterThan" value="0.5"/></Node>
      <Node id="k2" score="5.0">
        <SimplePredicate field="c" operator="lessOrEqual" value="0.5"/></Node>
    </Node></Node></Node>"""
_NO_DEFAULT = _DEFAULT_CHILD.replace(' defaultChild="m1"', "")


# tests/test_gtrees.py TestGeneralClassification's document
GENERAL_CLASSIFICATION = """<PMML xmlns="http://www.dmg.org/PMML-4_3"
  version="4.3"><Header/><DataDictionary numberOfFields="3">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="b" optype="continuous" dataType="double"/>
    <DataField name="y" optype="categorical" dataType="string">
      <Value value="p"/><Value value="q"/><Value value="r"/></DataField>
  </DataDictionary>
  <TreeModel functionName="classification" missingValueStrategy="none">
    <MiningSchema><MiningField name="y" usageType="target"/>
      <MiningField name="a"/><MiningField name="b"/></MiningSchema>
    <Node id="0"><True/>
      <Node id="1" score="p"><CompoundPredicate booleanOperator="and">
        <SimplePredicate field="a" operator="lessThan" value="0"/>
        <SimplePredicate field="b" operator="lessThan" value="0"/>
      </CompoundPredicate></Node>
      <Node id="2" score="q">
        <SimplePredicate field="a" operator="lessThan" value="0"/></Node>
      <Node id="3" score="r"><True/></Node>
    </Node></TreeModel></PMML>"""

# tests/test_trees_extended.py test_nested_with_sets_and_missing_ops's
NESTED_WITH_SETS = (
    '<PMML version="4.3"><DataDictionary>'
    '<DataField name="color" optype="categorical" dataType="string">'
    '<Value value="red"/><Value value="green"/><Value value="blue"/>'
    "</DataField>"
    '<DataField name="x" optype="continuous" dataType="double"/>'
    "</DataDictionary>"
    '<TreeModel functionName="regression" missingValueStrategy="none">'
    '<MiningSchema><MiningField name="color"/><MiningField name="x"/>'
    "</MiningSchema>"
    '<Node id="r"><True/>'
    '<Node id="l" score="7">'
    '<CompoundPredicate booleanOperator="or">'
    '<CompoundPredicate booleanOperator="and">'
    '<SimpleSetPredicate field="color" booleanOperator="isIn">'
    '<Array n="2" type="string">red blue</Array></SimpleSetPredicate>'
    '<SimplePredicate field="x" operator="greaterThan" value="0"/>'
    "</CompoundPredicate>"
    '<SimplePredicate field="x" operator="isMissing"/>'
    "</CompoundPredicate></Node>"
    '<Node id="rr" score="-7"><True/></Node>'
    "</Node></TreeModel></PMML>"
)


class TestGeneralScan:
    @pytest.mark.parametrize("case", sorted(_G))
    @pytest.mark.parametrize("strategy", ["none", "nullPrediction",
                                          "lastPrediction"])
    def test_general_shapes(self, case, strategy):
        check(_gtree(_G[case], strategy), jg._grid())

    @pytest.mark.parametrize("strategy", ["none", "nullPrediction",
                                          "lastPrediction"])
    def test_surrogate_all_unknown_uses_strategy(self, strategy):
        check(_gtree(_SURROGATE_SCORED, strategy), jg._grid())

    @pytest.mark.parametrize("body", [_DEFAULT_CHILD, _NO_DEFAULT],
                             ids=["default_child", "missing_default_child"])
    def test_default_child_with_compound(self, body):
        jm, tm = check(_gtree(body, "defaultChild"), jg._grid())
        dchild = tm.params["model"]["dchild"]
        assert (dchild < 0).any() and dchild.dtype == torch.int32
        # a lane that takes the missing default child is null
        if body is _NO_DEFAULT:
            [p] = tm.score_records([{"a": 0.5, "b": -1.0}])
            assert p.is_empty

    @pytest.mark.parametrize("ntc", ["returnLastPrediction",
                                     "returnNullPrediction"])
    def test_no_true_child(self, ntc):
        check(_gtree(_G["padded_child_slots"].replace(
            '<Node id="t2">', '<Node id="t2" score="6.0">'), ntc=ntc),
            jg._grid())

    def test_padded_child_slot_record_is_empty(self):
        _, _, tm = compile_both(_gtree(_G["padded_child_slots"]))
        [p] = tm.score_records([{"a": 1.0, "b": 0.5}])
        assert p.is_empty

    def test_classification(self):
        check(GENERAL_CLASSIFICATION, [{"a": -1.0, "b": -1.0}, {"a": -1.0, "b": 1.0},
                    {"a": 1.0, "b": -1.0}, {"a": 1.0}, {"b": 0.0}, {}])

    @pytest.mark.parametrize("pred", [
        je._comp("and", je._comp("or", je._sp("a", "lessThan", 0),
                                  je._sp("b", "greaterThan", 1)),
                 je._sp("c", "lessOrEqual", 0.5)),
        je._comp("or", je._comp("and", je._sp("a", "greaterOrEqual", 0),
                                je._sp("b", "lessThan", 0)),
                 je._comp("xor", je._sp("b", "greaterThan", 0),
                          je._sp("c", "greaterThan", 0))),
        je._comp("xor", je._comp("or", je._sp("a", "lessThan", 0),
                                 je._sp("b", "lessThan", 0)),
                 je._sp("c", "greaterThan", 0)),
        je._comp("and",
                 je._comp("or", je._comp("and", je._sp("a", "greaterThan", -1),
                                         je._sp("a", "lessThan", 1)),
                          je._sp("b", "equal", 0)),
                 je._comp("or", je._sp("c", "isMissing", 0),
                          je._sp("c", "greaterThan", -0.5))),
        je._comp("or", je._comp("and", je._sp("a", "notEqual", 0),
                                je._comp("or", je._sp("b", "lessThan", -0.3),
                                         je._sp("b", "greaterThan", 0.3))),
                 je._comp("and", je._sp("c", "isNotMissing", 0),
                          je._sp("c", "lessThan", 0))),
        je._comp("surrogate", je._sp("a", "lessThan", 0),
                 je._sp("b", "lessThan", 0), je._sp("c", "lessThan", 0)),
    ], ids=["and_or", "or_xor", "xor_or", "deep", "missing_ops",
            "flat_surrogate"])
    def test_nested_compounds(self, pred):
        check(je._nested_tree_xml(pred), je._nested_records(3))

    def test_nested_with_sets_and_missing_ops(self):
        xml = NESTED_WITH_SETS
        rng = np.random.default_rng(11)
        recs = []
        for _ in range(150):
            rec = {}
            if rng.random() > 0.3:
                rec["color"] = str(rng.choice(["red", "green", "blue",
                                               "violet"]))
            if rng.random() > 0.3:
                rec["x"] = float(rng.normal())
            recs.append(rec)
        check(xml, recs)

    def test_nested_surrogate_rejected_in_both(self):
        pred = je._comp("and", je._comp("surrogate",
                                        je._sp("a", "lessThan", 0),
                                        je._sp("b", "lessThan", 0)),
                        je._sp("c", "greaterThan", 0))
        xml = je._nested_tree_xml(pred)
        with pytest.raises(ModelCompilationException, match="surrogate"):
            compile_pmml(tparse(xml), device="cpu")

    def test_dnf_guard_rejects_a_blown_up_compound(self):
        kids = [je._comp("or", je._sp("a", "lessThan", i),
                         je._sp("b", "lessThan", i)) for i in range(6)]
        xml = je._nested_tree_xml(je._comp("and", *kids))  # 2^6 terms
        with pytest.raises(ModelCompilationException, match="DNF terms"):
            compile_pmml(tparse(xml), device="cpu")

    def test_chip_smoke_general_forest(self):
        # chip_smoke's rpart-style forest at a small size: surrogate
        # children, set splits over a categorical field, defaultChild on
        # half the nodes
        xml = cs.general_forest_xml(n_trees=5, n_continuous=6,
                                    n_categorical=2, n_values=8,
                                    max_leaves=24, max_depth=7, seed=2)
        jdoc, jm, tm = compile_both(xml)
        assert "psets" in tm.params["model"]
        rng = np.random.default_rng(7)
        X, M = seeded_rows(8, n=300, seed=7, missing=0.3)
        X[:, 6:] = rng.integers(0, 8, size=(300, 2))
        X[M] = 0.0
        assert_predict_match(jm, tm, X, M)
        records = [{f: (v if j < 6 else f"v{int(v)}")
                    for j, (f, v) in enumerate(zip(jm.field_space.fields,
                                                   row.tolist()))
                    if not M[i, j]} for i, row in enumerate(X[:60])]
        assert_records_match(jdoc, jm, tm, records)


# ---------------------------------------------------------------------------
# the weighted-path walk (tests/test_tree_halt.py TestWeightedStrategies)
# ---------------------------------------------------------------------------

_X_RECS = [{"x": v} for v in (-1.0, 0.0, 0.99, 1.0, 2.0, 5.0)] + [{}]


def _nested_agg():
    return jh.AGG_NODES.replace(
        '<Node id="L" recordCount="7" score="2.0">\n      '
        '<SimplePredicate field="x" operator="lessThan" value="1"/></Node>',
        '<Node id="L" recordCount="7">\n      '
        '<SimplePredicate field="x" operator="lessThan" value="1"/>\n'
        '      <Node id="LL" recordCount="5" score="1.0">\n        '
        '<SimplePredicate field="z" operator="lessThan" value="0"/></Node>\n'
        '      <Node id="LR" recordCount="2" score="4.0">\n        '
        '<SimplePredicate field="z" operator="greaterOrEqual" value="0"/>'
        "</Node>\n    </Node>",
    ).replace(
        "<DataDictionary>",
        '<DataDictionary><DataField name="z" optype="continuous" '
        'dataType="double"/>',
    ).replace('<MiningField name="x"/>',
              '<MiningField name="x"/><MiningField name="z"/>')


class TestWeightedWalk:
    @pytest.mark.parametrize("xml", [
        jh.WEIGHTED_CONF, jh.AGG_NODES,
        # the leaf score disagrees with its max confidence
        jh.WEIGHTED_CONF.replace(
            '<ScoreDistribution value="a" recordCount="45"/>\n      '
            '<ScoreDistribution value="b" recordCount="15"/>',
            '<ScoreDistribution value="a" recordCount="24"/>\n      '
            '<ScoreDistribution value="b" recordCount="36"/>'),
        # a leaf score outside every distribution
        jh.WEIGHTED_CONF.replace('<Node id="L" recordCount="60" score="a">',
                                 '<Node id="L" recordCount="60" '
                                 'score="other">'),
    ], ids=["weighted_confidence", "aggregate_nodes", "score_disagrees",
            "score_outside"])
    def test_weighted_strategies(self, xml):
        check(xml, _X_RECS)

    def test_nested_partial_missing(self):
        recs = [{"x": 0.0}, {"x": 0.0, "z": -1.0}, {"x": 0.0, "z": 1.0},
                {"z": 1.0}, {"x": 3.0}, {}]
        check(_nested_agg(), recs)

    def test_majority_vote_of_weighted_trees(self):
        tree = jh.WEIGHTED_CONF[jh.WEIGHTED_CONF.index("<TreeModel"):
                                jh.WEIGHTED_CONF.index("</TreeModel>")
                                + len("</TreeModel>")]
        xml = jh.WEIGHTED_CONF[:jh.WEIGHTED_CONF.index("<TreeModel")] + (
            '<MiningModel functionName="classification"><MiningSchema>'
            '<MiningField name="cls" usageType="target"/>'
            '<MiningField name="x"/></MiningSchema>'
            '<Segmentation multipleModelMethod="majorityVote">'
            f"<Segment><True/>{tree}</Segment>"
            f"<Segment><True/>{tree}</Segment>"
            "</Segmentation></MiningModel></PMML>")
        check(xml, _X_RECS)

    def test_requires_record_count(self):
        xml = jh.AGG_NODES.replace(' recordCount="7"', "")
        with pytest.raises(ModelCompilationException, match="recordCount"):
            compile_pmml(tparse(xml), device="cpu")

    def test_chip_smoke_copies_equal_the_jax_fixtures(self):
        assert cs.WEIGHTED_CONF == jh.WEIGHTED_CONF
        assert cs.AGG_NODES == jh.AGG_NODES
        assert cs.SELECT_ALL == je.SELECT_ALL


# ---------------------------------------------------------------------------
# the rank wire declines these shapes in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["deep", "halting", "general"])
def test_rank_wire_declines_deep_halting_and_general_forests(shape):
    """``quantized_scorer()`` is None in both packages, so ``BlockPipeline``
    takes the f32 dispatch: a decline, not a failed build."""
    if shape == "general":
        xml = cs.general_forest_xml(n_trees=3, n_continuous=4,
                                    n_categorical=0, max_leaves=12,
                                    max_depth=5, seed=1)
    elif shape == "deep":
        xml = cs.deep_rf_xml(n_trees=3, n_fields=4, max_leaves=30, seed=1)
    else:  # depth ≤ 4: the halt alone declines
        xml = cs.deep_rf_xml(n_trees=3, n_fields=4, max_leaves=8,
                             max_depth=4, min_depth=2, seed=1).replace(
            'missingValueStrategy="defaultChild"',
            'missingValueStrategy="lastPrediction"')
    _, jm, tm = compile_both(xml)
    assert jm.quantized_scorer() is None
    assert tm.quantized_scorer() is None
