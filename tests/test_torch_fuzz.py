"""The port's twin of tests/test_fuzz.py: random models, random dirty
records — the port's compiled engine against its oracle, and against
the JAX package, lane by lane.

The seven classes keep the JAX file's seed ranges (94 cases). Each seed
checks three things:

- the draw order: the port's generator (``tools/fuzzgen.py``) and the
  JAX one give the same model and records, compared as canonical dumps
  (dataclass names and fields; the IR classes carry the same names in
  both packages), so a drift names the first field that differs;
- the port's model compiled on the CPU against the port's oracle
  (``fuzzgen.assert_parity``: rel 2e-4 / abs 2e-5, empties and labels
  equal, the f32-overflow rule);
- the port's ``score_records`` against the JAX package's over the same
  records: empties and labels equal, values within rel 2e-4 / abs 2e-5.

The mining, scorecard and ARIMA generators are inline in the JAX test
classes, so their JAX side is copied here (``_jax_*``) from those
classes, on the JAX package's IR.
"""

import dataclasses

import numpy as np
import pytest

import test_fuzz as jf
from flink_jpmml_tpu.compile import compile_pmml as jax_compile
from flink_jpmml_tpu.pmml import ir as jir
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.tools import fuzzgen as fg


def canonical(obj):
    """A comparable dump: dataclasses by class name and fields, floats by
    repr (so NaN equals NaN), sequences as tuples."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("@dc", type(obj).__name__, tuple(
            (f.name, canonical(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)))
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), canonical(obj.tolist()))
    if isinstance(obj, (list, tuple)):
        return tuple(canonical(v) for v in obj)
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            ((str(k), canonical(v)) for k, v in obj.items()),
            key=lambda kv: kv[0])))
    if isinstance(obj, (float, np.floating)):
        return repr(float(obj))
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def _is_dc(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and x[0] == "@dc"


def first_diff(a, b, path="doc"):
    """The path of the first difference of two canonical dumps (None
    when they are equal), e.g. ``doc.model.root.predicate: class
    SimpleSetPredicate != TruePredicate``."""
    if _is_dc(a) and _is_dc(b):
        if a[1] != b[1]:
            return f"{path}: class {a[1]} != {b[1]}"
        for (name, x), (_, y) in zip(a[2], b[2]):
            d = first_diff(x, y, f"{path}.{name}")
            if d:
                return d
        return None
    if isinstance(a, tuple) and isinstance(b, tuple):
        if len(a) != len(b):
            return f"{path}: {len(a)} items != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


# -- the JAX side of the generators the JAX test classes write inline -------


def _jax_mining(rng):
    # tests/test_fuzz.py TestFuzzMining.test_random_regression_ensemble_parity
    n_seg = int(rng.integers(2, 5))
    segments = tuple(
        jir.Segment(
            predicate=(
                jir.TruePredicate()
                if rng.random() < 0.5
                else jf._rand_predicate(rng, 1)
            ),
            model=jir.TreeModelIR(
                function_name="regression",
                mining_schema=jf._schema(),
                root=jf._rand_tree(rng, False, max_depth=2),
                missing_value_strategy=str(rng.choice(
                    ["none", "defaultChild", "nullPrediction"]
                )),
                split_characteristic="multiSplit",
            ),
            segment_id=f"s{i}",
            weight=float(np.round(rng.uniform(0.5, 2.0), 2)),
        )
        for i in range(n_seg)
    )
    method = str(rng.choice(
        ["sum", "average", "weightedAverage", "max", "median",
         "selectFirst"]
    ))
    return jir.MiningModelIR(
        function_name="regression",
        mining_schema=jf._schema(),
        segmentation=jir.Segmentation(
            multiple_model_method=method, segments=segments
        ),
    )


def _jax_scorecard(rng):
    # tests/test_fuzz.py TestFuzzScorecard.test_random_scorecard_parity
    chars = []
    for ci in range(int(rng.integers(1, 4))):
        attrs = [
            jir.ScorecardAttribute(
                predicate=jf._rand_predicate(rng, 1),
                partial_score=float(np.round(rng.normal(0, 20), 1)),
            )
            for _ in range(int(rng.integers(1, 4)))
        ]
        if rng.random() < 0.8:
            attrs.append(jir.ScorecardAttribute(
                predicate=jir.TruePredicate(),
                partial_score=float(np.round(rng.normal(0, 5), 1)),
            ))
        chars.append(jir.Characteristic(
            name=f"ch{ci}", attributes=tuple(attrs)
        ))
    return jir.ScorecardIR(
        function_name="regression",
        mining_schema=jf._schema(),
        characteristics=tuple(chars),
        initial_score=float(np.round(rng.normal(100, 20), 1)),
        use_reason_codes=False,
    )


def _jax_sarima(rng):
    # tests/test_fuzz.py TestFuzzArima.test_random_sarima_parity
    from flink_jpmml_tpu.pmml import parse_pmml
    from test_timeseries import _arima_xml, _ns, _sc

    p = int(rng.integers(0, 3))
    d = int(rng.integers(0, 2))
    q = int(rng.integers(0, 3))
    s = int(rng.integers(2, 5)) if rng.random() < 0.6 else 0
    P = int(rng.integers(0, 2)) if s else 0
    D = int(rng.integers(0, 2)) if s else 0
    Q = int(rng.integers(0, 2)) if s else 0
    if s and not (P or D or Q):
        D = 1

    def coefs(n):
        return tuple(round(float(v), 3)
                     for v in rng.uniform(-0.65, 0.65, size=n))

    n_res = q + s * Q
    residuals = tuple(
        round(float(v), 3) for v in rng.normal(0, 0.4, size=n_res)
    )
    n_hist = d + s * D + (p + s * P) + int(rng.integers(8, 16))
    t = np.arange(n_hist)
    hist = tuple(
        round(float(v), 3)
        for v in 40
        + 0.8 * t
        + (4 * np.sin(2 * np.pi * t / s) if s else 0)
        + rng.normal(0, 1.0, size=n_hist)
    )
    transformation = str(
        rng.choice(("none", "none", "logarithmic", "squareroot"))
    )
    body = _ns(p, d, q, ar=coefs(p), ma=coefs(q),
               residuals=residuals if n_res else ())
    if s:
        body += _sc(P, D, Q, s, sar=coefs(P), sma=coefs(Q))
    doc = parse_pmml(_arima_xml(
        body, hist,
        constant=round(float(rng.uniform(-0.5, 0.5)), 3),
        transformation=transformation,
    ))
    recs = []
    for _ in range(24):
        roll = rng.random()
        if roll < 0.1:
            recs.append({})
        elif roll < 0.2:
            recs.append({"h": None})
        elif roll < 0.3:
            recs.append({"h": float(rng.uniform(0.6, 20.0))})
        else:
            recs.append({"h": int(rng.integers(1, 31))})
    return doc, recs


def _port_model(gen, n):
    def make(rng):
        doc = fg.make_doc(gen(rng))
        return doc, fg.rand_records(rng, n)
    return make


def _jax_model(gen, n):
    def make(rng):
        doc = jf._doc(gen(rng))
        return doc, jf._rand_records(rng, n)
    return make


def _port_sarima(rng):
    doc = fg.rand_sarima_doc(rng)
    return doc, fg.rand_sarima_records(rng, 24)


def _values(preds):
    return [None if p.is_empty else getattr(p.score, "value", None)
            for p in preds]


def check_seed(seed, port_gen, jax_gen, where):
    doc, recs = port_gen(np.random.default_rng(seed))
    jdoc, jrecs = jax_gen(np.random.default_rng(seed))
    # the draw order: the same model and the same records
    diff = first_diff(canonical(doc), canonical(jdoc))
    assert diff is None, f"{where}: the port's model differs: {diff}"
    diff = first_diff(canonical(recs), canonical(jrecs), "records")
    assert diff is None, f"{where}: the port's records differ: {diff}"
    # the port against its oracle
    fg.assert_parity(doc, recs, where, "cpu")
    # the port against the JAX package
    port = compile_pmml(doc, device="cpu").score_records(recs)
    ref = jax_compile(jdoc).score_records(jrecs)
    assert len(port) == len(ref) == len(recs)
    for i, (p, j) in enumerate(zip(port, ref)):
        ctx = f"{where} record {i}: {recs[i]!r}"
        assert p.is_empty == j.is_empty, f"{ctx}: port {p!r}, jax {j!r}"
        if p.is_empty:
            continue
        pl, jl = (getattr(x.target, "label", None) for x in (p, j))
        assert pl == jl, f"{ctx}: label {pl!r} != {jl!r}"
        pv, jv = _values([p])[0], _values([j])[0]
        assert (pv is None) == (jv is None), f"{ctx}: {pv!r} vs {jv!r}"
        if jv is not None:
            assert fg.close(pv, jv), f"{ctx}: value {pv!r} != {jv!r}"


class TestFuzzTrees:
    @pytest.mark.parametrize("seed", range(25))
    def test_random_tree_parity(self, seed):
        check_seed(1000 + seed, _port_model(fg.rand_tree_model, 48),
                   _jax_model(jf._rand_tree_model, 48),
                   f"tree seed={seed}")


class TestFuzzMining:
    @pytest.mark.parametrize("seed", range(12))
    def test_random_regression_ensemble_parity(self, seed):
        check_seed(2000 + seed, _port_model(fg.rand_mining_model, 32),
                   _jax_model(_jax_mining, 32), f"mining seed={seed}")


class TestFuzzRegression:
    @pytest.mark.parametrize("seed", range(15))
    def test_random_regression_parity(self, seed):
        check_seed(3000 + seed, _port_model(fg.rand_regression_model, 40),
                   _jax_model(jf._rand_regression_model, 40),
                   f"regression seed={seed}")


class TestFuzzScorecard:
    @pytest.mark.parametrize("seed", range(10))
    def test_random_scorecard_parity(self, seed):
        check_seed(4000 + seed, _port_model(fg.rand_scorecard_model, 40),
                   _jax_model(_jax_scorecard, 40),
                   f"scorecard seed={seed}")


class TestFuzzNeural:
    @pytest.mark.parametrize("seed", range(10))
    def test_random_mlp_parity(self, seed):
        check_seed(5000 + seed, _port_model(fg.rand_nn_model, 32),
                   _jax_model(jf._rand_nn_model, 32), f"nn seed={seed}")


class TestFuzzGlm:
    @pytest.mark.parametrize("seed", range(10))
    def test_random_glm_parity(self, seed):
        check_seed(6000 + seed, _port_model(fg.rand_glm_model, 32),
                   _jax_model(jf._rand_glm_model, 32), f"glm seed={seed}")


class TestFuzzArima:
    """Random SARIMA state through the full pipeline (XML → parser →
    compile against the oracle and the JAX package)."""

    @pytest.mark.parametrize("seed", range(12))
    def test_random_sarima_parity(self, seed):
        check_seed(9000 + seed, _port_sarima, _jax_sarima,
                   f"sarima seed={seed}")


def test_a_draw_out_of_order_fails_by_name():
    """The canonical dump names the field where two models part: a
    generator that draws in another order gives another tree, and the
    message says where."""
    rng = np.random.default_rng(1000)
    doc = fg.make_doc(fg.rand_tree_model(rng))
    rng = np.random.default_rng(1000)
    rng.random()  # one draw ahead
    other = fg.make_doc(fg.rand_tree_model(rng))
    diff = first_diff(canonical(doc), canonical(other))
    assert diff == ("doc.model.root.predicate: class SimpleSetPredicate "
                    "!= TruePredicate"), diff
