"""The port's device encode stage and fused scoring against the JAX
package's (tests/test_fused_encode.py, case for case), on the CPU:

- byte parity of ``QuantizedScorer.encode_device`` with the port's
  ``wire.encode`` and the JAX package's ``encode_device``, code for code
  and dtype for dtype: NaN, the uint16 wire, ``missingValueReplacement``,
  an explicit mask, ±inf, exact cut values, ±0.0;
- fused scoring (``predict_fused``) against the port's host-encoded
  ``predict_wire`` (the same codes, so the same bits) and the JAX
  package's ``predict_fused`` at the rank-wire bar rtol 1e-4 / atol 1e-5,
  with pad-lane trimming on odd batches and a vote forest's (value,
  shares, label) triple — labels equal on rows without a vote tie;
- ``runtime.pipeline.dispatch_quantized`` taking either placement, its
  ``h2d_bytes`` / ``encode_*`` accounting, and a model over the device
  table budget staying host-encoded.
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_cells
from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.pmml import parse_pmml as jparse_str
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees, qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.pmml import parse_pmml, parse_pmml_file
from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from test_fused_encode import _REPL_XML, _rand_X
from test_qtrees import _forest_xml
from test_torch_votes import _segment_weights, _vote_totals, check_labels

RTOL, ATOL = 1e-4, 1e-5


def _scorers(path=None, xml=None, batch_size=None):
    """(the port's scorer on the CPU, the JAX package's XLA scorer)."""
    if xml is not None:
        td, jd = parse_pmml(xml), jparse_str(xml)
    else:
        td, jd = parse_pmml_file(path), jparse(path)
    q = build_quantized_scorer(td, batch_size=batch_size, device="cpu")
    jq = jax_bqs(jd, batch_size=batch_size, backend="xla")
    assert q is not None and jq is not None
    return q, jq


def _gbm(tmp_path, batch_size=None, **kw):
    return _scorers(gen_gbm(str(tmp_path), **kw), batch_size=batch_size)


class TestEncodeByteParity:
    def _assert_codes_equal(self, q, jq, X, M=None):
        host = q.wire.encode(X, M)
        Xd = X if M is None else np.where(M, np.nan, X).astype(np.float32)
        dev = q.encode_device(Xd)
        assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
        dev = dev.numpy()
        jdev = np.asarray(jq.encode_device(Xd))
        assert dev.dtype == host.dtype == jdev.dtype == q.wire.dtype
        np.testing.assert_array_equal(dev, host)
        np.testing.assert_array_equal(dev, jdev)
        return dev

    def test_uint8_wire_with_nans(self, tmp_path):
        q, jq = _gbm(tmp_path, 64, n_trees=15, depth=4, n_features=8)
        assert q.supports_fused and q.wire.dtype is np.uint8
        rng = np.random.default_rng(0)
        self._assert_codes_equal(q, jq, _rand_X(rng, 64, 8, missing_rate=0.3))

    def test_uint16_wire(self, tmp_path):
        # > 254 cuts a feature: the sentinel is 65535 and ranks go through
        # int32 before the last cast
        q, jq = _gbm(tmp_path, 32, n_trees=300, depth=5, n_features=2,
                     hist_bins=None)
        assert q.wire.dtype is np.uint16 and q.supports_fused
        rng = np.random.default_rng(1)
        dev = self._assert_codes_equal(q, jq, _rand_X(rng, 32, 2, 0.2))
        assert (dev == 65535).any() and (dev[dev != 65535] > 255).any()

    def test_missing_value_replacement_folds_in(self):
        q, jq = _scorers(xml=_REPL_XML, batch_size=8)
        assert q.supports_fused
        X = np.array(
            [[np.nan, -0.5], [np.nan, 0.5], [0.0, np.nan], [2.0, -1.0]],
            np.float32,
        )
        dev = self._assert_codes_equal(q, jq, X)
        # column a declares a replacement: no sentinel even for NaN
        assert (dev[:2, 0] != q.wire.sentinel).all()
        # column b declares none: NaN is the sentinel
        assert dev[2, 1] == q.wire.sentinel

    def test_explicit_mask_folds_as_nan(self, tmp_path):
        q, jq = _gbm(tmp_path, 16, n_trees=10, depth=3, n_features=4)
        rng = np.random.default_rng(2)
        X = _rand_X(rng, 16, 4)
        M = rng.random(size=X.shape) < 0.25
        self._assert_codes_equal(q, jq, np.where(M, 0.0, X).astype(np.float32),
                                 M)

    def test_infinite_cells(self, tmp_path):
        # +inf ranks past every real cut (never the sentinel, never moved
        # by the +inf pads); -inf ranks 0
        q, jq = _gbm(tmp_path, 8, n_trees=10, depth=3, n_features=4)
        rng = np.random.default_rng(3)
        X = _rand_X(rng, 8, 4)
        X[0, 0], X[1, 1], X[2, 2] = np.inf, -np.inf, np.nan
        dev = self._assert_codes_equal(q, jq, X)
        assert dev[0, 0] == len(q.wire.cuts[0]) and dev[1, 1] == 0

    def test_exact_cut_values_rank_left(self, tmp_path):
        # x equal to a cut ranks strictly-less (#{c < x})
        q, jq = _gbm(tmp_path, None, n_trees=12, depth=4, n_features=4)
        rows = []
        for j, c in enumerate(q.wire.cuts):
            if len(c):
                row = np.zeros((len(q.wire.cuts),), np.float32)
                row[j] = c[len(c) // 2]
                rows.append(row)
        self._assert_codes_equal(q, jq, np.asarray(rows, np.float32))

    @pytest.mark.parametrize("hist_bins", [254, None], ids=["u8", "u16"])
    def test_edge_cells(self, tmp_path, hist_bins):
        # chip_smoke's cells: NaN, ±inf, ±0.0 and exact cut values at once
        q, jq = _gbm(tmp_path, None, n_trees=60, depth=4, n_features=6,
                     hist_bins=hist_bins)
        X = edge_cells(np.random.default_rng(4), q.wire.cuts, 5_003)
        self._assert_codes_equal(q, jq, X)

    def test_encode_device_takes_a_tensor(self, tmp_path):
        q, _ = _gbm(tmp_path, 16, n_trees=10, depth=3, n_features=4)
        X = _rand_X(np.random.default_rng(5), 16, 4, missing_rate=0.2)
        np.testing.assert_array_equal(
            q.encode_device(torch.from_numpy(X)).numpy(), q.wire.encode(X))


class TestFusedScoringParity:
    def test_regression_all_lanes(self, tmp_path):
        B = 64
        q, jq = _gbm(tmp_path, B, n_trees=21, depth=4, n_features=8)
        assert q.backend == "cuda_plain"
        rng = np.random.default_rng(4)
        for n in (B, B - 9, 2 * B, 2 * B + 7):
            X = _rand_X(rng, n, 8, missing_rate=0.2)
            fused = q.predict_fused(X).numpy()
            assert fused.shape == (-(-n // B) * B,)
            host = q.predict_wire(q.wire.encode(X)).numpy()
            # the same codes through the same scorer: the same bits
            np.testing.assert_array_equal(fused[:n], host[:n])
            jfused = np.asarray(jq.predict_fused(X), np.float32)[:n]
            np.testing.assert_allclose(fused[:n], jfused, rtol=RTOL, atol=ATOL)
            assert [p.score.value for p in q.decode(q.predict_fused(X), n)] \
                == [p.score.value for p in q.score(X)]

    def test_torch_twin_fused(self, tmp_path):
        # a uint16 wire scores on the torch twin, fused in front of it too
        B = 32
        q, jq = _gbm(tmp_path, B, n_trees=300, depth=5, n_features=2,
                     hist_bins=None)
        assert q.backend == "torch" and q.wire.dtype is np.uint16
        X = _rand_X(np.random.default_rng(5), 2 * B + 5, 2, missing_rate=0.2)
        fused = q.predict_fused(X).numpy()[: len(X)]
        host = q.predict_wire(q.wire.encode(X)).numpy()[: len(X)]
        np.testing.assert_array_equal(fused, host)
        np.testing.assert_allclose(
            fused, np.asarray(jq.predict_fused(X), np.float32)[: len(X)],
            rtol=RTOL, atol=ATOL)

    def test_classification_triple_fused(self):
        B = 32
        xml = _forest_xml("majorityVote", n_trees=8)
        q, jq = _scorers(xml=xml, batch_size=B)
        assert q.is_classification and q.supports_fused
        assert q.backend == "cuda_plain"
        X = _rand_X(np.random.default_rng(6), B - 5, 4, missing_rate=0.2)
        n = X.shape[0]
        fv, fp, fl = (o.numpy()[:n] for o in q.predict_fused(X))
        hv, hp, hl = (o.numpy()[:n] for o in q.predict_wire(q.wire.encode(X)))
        np.testing.assert_array_equal(fl, hl)
        np.testing.assert_array_equal(fp, hp)
        np.testing.assert_array_equal(fv, hv)
        jv, jp, jl = (np.asarray(o)[:n] for o in jq.predict_fused(X))
        np.testing.assert_allclose(fp, jp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fv, jv, rtol=RTOL, atol=ATOL)
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        totals = _vote_totals(tables, q.params["lab"].numpy(),
                              _segment_weights(parse_pmml(xml)),
                              torch.from_numpy(q.wire.encode(X)))
        check_labels(fl, jl, totals, lowest=False)

    def test_f32_reference_agreement(self, tmp_path):
        B = 64
        doc = parse_pmml_file(gen_gbm(str(tmp_path), n_trees=15, depth=4,
                                      n_features=6))
        cm = compile_pmml(doc, batch_size=B, device="cpu")
        q = cm.quantized_scorer()
        X = _rand_X(np.random.default_rng(7), B, 6, missing_rate=0.25)
        M = np.isnan(X)
        ref = cm.predict(torch.from_numpy(np.nan_to_num(X, nan=0.0)),
                         torch.from_numpy(M)).value.numpy()
        np.testing.assert_allclose(q.predict_fused(X).numpy(), ref,
                                   rtol=RTOL, atol=ATOL)


class TestDispatch:
    def _scorer(self, tmp_path):
        q, _ = _gbm(tmp_path, 32, n_trees=10, depth=3, n_features=4)
        return q

    @pytest.mark.parametrize("device,staged,mode,placement", [
        ("cuda", True, None, "fused"),
        ("cuda", False, None, "host"),
        ("cpu", True, None, "host"),
        ("cuda", True, "host", "host"),
        ("cpu", True, "fused", "fused"),
        ("cuda", False, "fused", "host"),
    ])
    def test_placement_follows_device_and_stage(self, tmp_path, device,
                                                staged, mode, placement):
        # decided from what the scorer sees unless encode_mode overrides
        # it; only the placement is read, so no card is needed
        q = self._scorer(tmp_path)
        q.device = torch.device(device)
        if not staged:
            q._encode_stage = None
        q.encode_mode = mode
        assert q.encode_placement == placement

    def test_fused_vs_host_identical_scores(self, tmp_path):
        q = self._scorer(tmp_path)
        X = _rand_X(np.random.default_rng(8), 32, 4, missing_rate=0.2)
        q.encode_mode = "host"
        host = dispatch_quantized(q, X).result().numpy()
        q.encode_mode = "fused"
        assert q.encode_placement == "fused"
        fused = dispatch_quantized(q, X).result().numpy()
        np.testing.assert_array_equal(fused, host)

    def test_metrics_accounting(self, tmp_path):
        q = self._scorer(tmp_path)
        X = _rand_X(np.random.default_rng(9), 32, 4)
        m_host = MetricsRegistry()
        dispatch_quantized(q, X, metrics=m_host)
        assert m_host.counter("encode_s").get() > 0
        # uint8 wire: one byte a feature a record
        assert m_host.counter("h2d_bytes").get() == 32 * 4
        assert m_host.counter("encode_host").get() == 1
        assert q.staged_bytes_per_record == 4
        m_fused = MetricsRegistry()
        q.encode_mode = "fused"
        dispatch_quantized(q, X, metrics=m_fused)
        # fused ships raw f32: 4 bytes a feature a record
        assert m_fused.counter("h2d_bytes").get() == 32 * 4 * 4
        assert m_fused.counter("encode_fused").get() == 1
        assert q.staged_bytes_per_record == 16

    def test_mask_path_through_helper(self, tmp_path):
        q = self._scorer(tmp_path)
        rng = np.random.default_rng(10)
        X = _rand_X(rng, 32, 4)
        M = rng.random(size=X.shape) < 0.3
        Xz = np.where(M, 0.0, X).astype(np.float32)
        host = dispatch_quantized(q, Xz, M).result().numpy()
        q.encode_mode = "fused"
        fused = dispatch_quantized(q, Xz, M).result().numpy()
        np.testing.assert_array_equal(fused, host)
        # the fold made a copy: the caller's batch keeps its zeros
        assert not np.isnan(Xz).any()

    def test_over_budget_model_stays_host_encoded(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.setattr(qtrees, "_DEVICE_TABLE_BUDGET", 64)
        q = self._scorer(tmp_path)
        assert not q.supports_fused and "enc_cuts" not in q.params
        q.encode_mode = "fused"
        assert q.encode_placement == "host"
        X = _rand_X(np.random.default_rng(11), 32, 4, missing_rate=0.2)
        m = MetricsRegistry()
        out = dispatch_quantized(q, X, metrics=m).result().numpy()
        assert out.shape == (32,)
        assert m.counter("h2d_bytes").get() == 32 * 4
        assert m.counter("encode_host").get() == 1
        assert m.counter("encode_fused").get() == 0
        with pytest.raises(ModelCompilationException):
            q.encode_device(X)
