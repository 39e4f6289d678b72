"""Front end of the PyTorch port against the JAX package: the copied
parser yields the same IR field by field, preparation and decode agree,
and the port's bf16 hi/lo split equals the JAX package's bit for bit."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.assets_gen import gen_gbm as jax_gen_gbm
from flink_jpmml_tpu.compile import prepare as jprep
from flink_jpmml_tpu.compile.qtrees import _split_bf16 as jax_split_bf16
from flink_jpmml_tpu.models.prediction import decode_batch as jdecode
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import prepare as tprep
from flink_jpmml_tpu_torch.compile.qtrees import _split_bf16
from flink_jpmml_tpu_torch.models.prediction import decode_batch as tdecode
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse


def _norm(obj):
    """IR → nested plain values (class name + fields), comparable across
    the two packages' separate dataclass types."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {
            f.name: _norm(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, (list, tuple)):
        return [_norm(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return _norm(obj.tolist())
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj


GBM_SIZES = [
    dict(n_trees=3, depth=2, n_features=4),
    dict(n_trees=21, depth=4, n_features=8),
    dict(n_trees=40, depth=4, n_features=8, hist_bins=None),
    dict(n_trees=60, depth=6, n_features=32),
]


@pytest.mark.parametrize("kw", GBM_SIZES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_ir_equal_field_by_field(tmp_path, kw):
    path = gen_gbm(str(tmp_path), **kw)
    with open(path, "rb") as f:
        ours = f.read()
    with open(jax_gen_gbm(str(tmp_path), name="jax.pmml", **kw), "rb") as f:
        assert f.read() == ours  # the generator copy writes the same bytes
    assert _norm(tparse(path)) == _norm(jparse(path))


def test_ir_equal_on_generated_fixture_set(assets_dir):
    paths = sorted(p for p in assets_dir.glob("*.pmml")
                   if p.name not in ("malformed.pmml", "no_model.pmml",
                                     "unsupported_version.pmml"))
    assert len(paths) >= 5
    for p in paths:
        assert _norm(tparse(str(p))) == _norm(jparse(str(p))), p.name


def test_prepare_and_decode_agree(tmp_path):
    doc_t = tparse(gen_gbm(str(tmp_path), n_trees=3, depth=2, n_features=4))
    fields = doc_t.active_fields
    rng = np.random.default_rng(4)
    records = [
        {f: (None if rng.random() < 0.2 else float(rng.normal()))
         for f in fields}
        for _ in range(17)
    ]
    Xt, Mt = tprep.from_records(tprep.FieldSpace(fields=fields, codecs={}), records)
    Xj, Mj = jprep.from_records(jprep.FieldSpace(fields=fields, codecs={}), records)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Mt, Mj)
    Pt = tprep.pad_batch(Xt, Mt, 32)
    Pj = jprep.pad_batch(Xj, Mj, 32)
    for a, b in zip(Pt, Pj):
        np.testing.assert_array_equal(a, b)
    vals = rng.normal(size=17).tolist()
    valid = (rng.random(17) > 0.3).tolist()
    assert [repr(p) for p in tdecode(vals, valid, None, None)] == [
        repr(p) for p in jdecode(vals, valid, None, None)
    ]


def test_split_bf16_bit_identical():
    rng = np.random.default_rng(9)
    v = np.concatenate([
        rng.normal(0.0, 0.1, size=500),
        rng.normal(0.0, 1e4, size=100),
        rng.uniform(-1e-30, 1e-30, size=50),
        [0.0, -0.0, 1.0, 3.0, 1 / 3],
    ]).astype(np.float32).reshape(-1, 5)
    hi_t, lo_t = _split_bf16(v)
    hi_j, lo_j = jax_split_bf16(v)
    assert hi_t.dtype == torch.bfloat16 and lo_t.dtype == torch.bfloat16
    bits = lambda t: t.view(torch.int16).numpy()  # noqa: E731
    np.testing.assert_array_equal(bits(hi_t), hi_j.view(np.int16))
    np.testing.assert_array_equal(bits(lo_t), lo_j.view(np.int16))
