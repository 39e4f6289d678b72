"""Cross-model packs in the port (compile/packs.py) and the packed launch
of the walk kernel (qtrees_cuda.leaf_rows_packed), on the CPU.

- The packed launch's plain version equals each member's solo plain
  version bit for bit (ragged row counts, mixed class counts, members of
  different widths), and the wrapper routes a CPU tensor to it.
- ``PackedScorer.dispatch`` equals each member's solo ``predict_wire``
  byte for byte — ``"cuda_plain"`` members through the packed launch,
  ``"torch"`` members through their qfn, in uint8 and widened uint16
  buffers, over hostile lanes — and the JAX ``PackedScorer`` over the
  same documents at the rank wire's rtol 1e-4 / atol 1e-5, labels equal.
- Eligibility, the pack cap and the model-set hash are the JAX module's.
"""

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.compile import packs as jpacks
from flink_jpmml_tpu.pmml import parse_pmml as jparse_str
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import compile_pmml, layouts, packs
from flink_jpmml_tpu_torch.compile import qtrees_cuda as qc
from flink_jpmml_tpu_torch.pmml import parse_pmml, parse_pmml_file
from test_layouts import stump_forest_xml

B = 32
RTOL, ATOL = 1e-4, 1e-5


def _docs(tmp_path):
    """name → (pmml path or xml text, fields): GBMs of 3–8 trees at depth
    3 over 4 features, a 3-class vote forest, a uint16 stump forest."""
    d = str(tmp_path)
    out = {
        f"gbm{i}": (gen_gbm(d, n_trees=t, depth=3, n_features=4, seed=s,
                            name=f"g{i}"), None)
        for i, (t, s) in enumerate(((3, 7), (5, 8), (8, 9)))
    }
    out["votes"] = (gen_vote_forest(d, n_trees=6, depth=3, n_features=4,
                                    n_classes=3, seed=3), None)
    out["wide"] = (None, stump_forest_xml())
    return out


def _port(doc_src, batch=B):
    path, xml = doc_src
    doc = parse_pmml_file(path) if path else parse_pmml(xml)
    return compile_pmml(doc, batch_size=batch, device="cpu").quantized_scorer()


def _jax(doc_src, batch=B):
    path, xml = doc_src
    doc = jparse(path) if path else jparse_str(xml)
    return jcompile(doc, batch_size=batch).quantized_scorer()


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    return _docs(tmp_path_factory.mktemp("packs"))


def _hostile(q, n, seed):
    """n raw rows for scorer q with NaN / ±inf lanes, encoded."""
    rng = np.random.default_rng(seed)
    F = len(q.wire.fields)
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    for i in range(n):
        k = i % 5
        if k == 1:
            X[i, i % F] = np.nan
        elif k == 2:
            X[i, i % F] = np.inf
        elif k == 3:
            X[i, i % F] = -np.inf
    return X


def _bytes(out):
    if isinstance(out, tuple):
        return tuple(_bytes(o) for o in out)
    return out.detach().numpy().tobytes()


def _trim(out, n):
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out)
    return out[:n]


# -- the packed launch ---------------------------------------------------------


def _member_tables(q):
    return {k: q.params[k] for k in qc.TABLE_KEYS}


@pytest.mark.parametrize("rows", [(32, 32, 32), (5, 0, 31), (1, 17, 32)])
def test_packed_plain_version_equals_each_solo_plain_version(docs, rows):
    qs = [_port(docs[k]) for k in ("gbm0", "votes", "gbm2")]
    assert all(q.backend == "cuda_plain" for q in qs)
    rng = np.random.default_rng(sum(rows))
    F = max(len(q.wire.fields) for q in qs)
    codes = torch.zeros((len(qs), B, F), dtype=torch.uint8)
    for m, q in enumerate(qs):
        X = _hostile(q, rows[m], m)
        codes[m, : rows[m], : len(q.wire.fields)] = torch.from_numpy(
            q.wire.encode(X))
        # junk past a member's rows and fields is never read
        codes[m, rows[m]:] = torch.from_numpy(
            rng.integers(0, 255, (B - rows[m], F), dtype=np.uint8))
    tables = [_member_tables(q) for q in qs]
    fields = [len(q.wire.fields) for q in qs]
    got = qc.leaf_rows_packed_reference(codes, list(rows), tables, fields)
    routed = qc.leaf_rows_packed(codes, list(rows), tables, fields)
    for m, q in enumerate(qs):
        solo = qc.leaf_rows_reference(
            codes[m, : rows[m], : fields[m]].contiguous(), tables[m])
        assert got[m].shape == (rows[m], tables[m]["rows"].shape[2])
        assert got[m].numpy().tobytes() == solo.numpy().tobytes()
        assert routed[m].numpy().tobytes() == solo.numpy().tobytes()


def test_packed_shape_takes_the_smallest_block_and_largest_need():
    # a member whose default block is 256 threads and one of 64 fields
    # wide enough to shrink its block
    small = (4, 3, 8, None, None)
    wide = (256, 500, 200, None, None)
    t_small = qc.launch_shape(*small)
    t_wide = qc.launch_shape(*wide)
    threads, chunks, smem = qc.packed_shape([small, wide])
    assert threads == min(t_small[0], t_wide[0])
    assert chunks == [t_small[1], t_wide[1]]
    assert smem == max(
        qc.BAR_BYTES + 2 * c * w * 8 + threads * qc.RECORDS_PER_THREAD
        * qc.staged_row_stride(f)
        for (f, _t, w, _, _), c in zip([small, wide], chunks))
    assert smem <= qc.SMEM_MAX
    with pytest.raises(ValueError):
        qc.packed_shape([small, (4, 3, 8, 48, None)])  # not a warp multiple
    with pytest.raises(ValueError):
        qc.packed_shape([])


def test_packed_launch_checks_its_operands(docs):
    q = _port(docs["gbm0"])
    t = _member_tables(q)
    codes = torch.zeros((1, B, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        qc.leaf_rows_packed(codes, [B + 1], [t], [4])
    with pytest.raises(ValueError):
        qc.leaf_rows_packed(codes, [B], [t], [5])
    with pytest.raises(ValueError):
        qc.leaf_rows_packed(codes.long(), [B], [t], [4])
    with pytest.raises(ValueError):
        qc.leaf_rows_packed(codes, [B, B], [t], [4])


def test_packed_launch_source_is_in_the_kernel_file():
    src = qc.SOURCE.read_text()
    assert 'extern "C" int qtrees_leaf_rows_packed(' in src
    assert "walk_packed_kernel" in src


# -- PackedScorer --------------------------------------------------------------


@pytest.mark.parametrize("names", [
    ("gbm0", "gbm1"),
    ("gbm0", "gbm1", "gbm2", "votes"),
    ("gbm1", "wide", "votes"),
    ("wide", "gbm0"),
])
def test_pack_dispatch_equals_solo_dispatch(docs, names):
    qs = [_port(docs[k]) for k in names]
    pack = packs.build_pack(qs, list(names))
    rows = {}
    for i, q in enumerate(qs):
        rows[i] = q.wire.encode(_hostile(q, B - 3 * i, 40 + i))
    Xp, total = pack.assemble(rows)
    assert total == sum(r.shape[0] for r in rows.values())
    if "wide" in names:
        assert pack.in_dtype is np.uint16 and Xp.dtype == np.uint16
    outs = pack.dispatch(Xp)
    live = pack.dispatch(Xp, [r.shape[0] for r in rows.values()])
    for i, q in enumerate(qs):
        solo = q.predict_wire(rows[i])
        assert _bytes(outs[i]) == _bytes(solo)
        n = rows[i].shape[0]
        assert _bytes(_trim(live[i], n)) == _bytes(_trim(solo, n))


def test_pack_dispatch_agrees_with_the_jax_pack(docs):
    names = ("gbm0", "gbm2", "votes", "wide")
    tq = [_port(docs[k]) for k in names]
    jq = [_jax(docs[k]) for k in names]
    tp = packs.build_pack(tq, list(names))
    jp = jpacks.build_pack(jq, list(names))
    rows_t, rows_j = {}, {}
    for i, (a, b) in enumerate(zip(tq, jq)):
        X = _hostile(a, B - i, 70 + i)
        rows_t[i] = a.wire.encode(X)
        rows_j[i] = b.wire.encode(X)
        assert np.array_equal(rows_t[i], rows_j[i])
    got = tp.dispatch(tp.assemble(rows_t)[0])
    ref = jp.dispatch(jp.assemble(rows_j)[0])
    for g, r, q in zip(got, ref, tq):
        if q.is_classification:
            assert np.array_equal(g[2].numpy(), np.asarray(r[2]))
            for a, b in zip(g[:2], r[:2]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=RTOL, atol=ATOL)


def test_pack_mixes_uint8_and_uint16_members(docs):
    qs = [_port(docs[k]) for k in ("gbm0", "wide")]
    assert [q.wire.dtype for q in qs] == [np.uint8, np.uint16]
    assert [q.backend for q in qs] == ["cuda_plain", "torch"]
    pack = packs.build_pack(qs, ["a", "b"])
    assert pack.in_dtype is np.uint16
    assert pack.pad_waste() > 0
    assert pack.buffer_bytes == 2 * B * pack.F_max * 2
    # the uint8 member's sentinel survives the widening unchanged
    X = np.full((4, len(qs[0].wire.fields)), np.nan, np.float32)
    Xp, _ = pack.assemble({0: qs[0].wire.encode(X)})
    assert (Xp[0, :4, : X.shape[1]] == 255).all()
    assert _bytes(pack.dispatch(Xp)[0]) == _bytes(
        qs[0].predict_wire(qs[0].wire.encode(X)))


def test_pack_state_dispatch_keeps_every_member_output(docs):
    from flink_jpmml_tpu_torch.runtime.state import (
        KeyedStateTable,
        StateSpec,
    )

    qs = [_port(docs[k]) for k in ("gbm0", "gbm1")]
    pack = packs.build_pack(qs, ["a", "b"])
    Xp, _ = pack.assemble({i: q.wire.encode(_hostile(q, B, i))
                           for i, q in enumerate(qs)})
    t = KeyedStateTable(StateSpec(capacity=64), device="cpu")
    slots, reset, rel, w = t.assign_slots(
        t.hash_keys(np.arange(B) % 7), np.arange(B))
    outs, derived, S2 = pack.dispatch_state(Xp, t, slots, rel, w, reset,
                                            member=1)
    plain = pack.dispatch(Xp)
    assert [_bytes(o) for o in outs] == [_bytes(o) for o in plain]
    assert derived.shape == (B, 8)
    t.commit(S2)
    v = t.host_values()
    assert v[:, 0].sum() == B
    assert np.float32(v[:, 1].sum()) == pytest.approx(
        float(plain[1].sum()), rel=1e-5)


def test_pack_eligibility_and_cap(docs, monkeypatch):
    qs = [_port(docs[k]) for k in ("gbm0", "gbm1", "gbm2")]
    assert all(packs.pack_eligible(q) for q in qs)
    assert not packs.pack_eligible(None)
    wide = _port(docs["wide"])
    assert packs.pack_eligible(wide)
    built = wide.build_variant("wirepack")
    wp = _port(docs["wide"])
    if built is not None:
        wp.adopt_variant(built, "wirepack")
        assert not packs.pack_eligible(wp)
    monkeypatch.setenv("FJT_PACK_MEMBER_BYTES", "1")
    assert not packs.pack_eligible(qs[0])  # re-evaluated under the new cap
    monkeypatch.delenv("FJT_PACK_MEMBER_BYTES")
    monkeypatch.setenv("FJT_PACK_MAX", "2")
    assert packs.pack_max() == 2
    with pytest.raises(ValueError):
        packs.build_pack(qs, ["a", "b", "c"])
    with pytest.raises(ValueError):
        packs.PackedScorer([qs[0], _port(docs["gbm1"], batch=16)],
                           ["a", "b"])
    assert len(max(layouts.pack_partitions(
        {f"h{i}": {"trees": 3.0} for i in range(5)}), key=len)[-1]) <= 2


def test_model_set_hash_is_the_jax_one():
    for hs in (["h1", "h2", "h3"], ["h3", "h1", "h2"], ["h1", "h1"], []):
        assert packs.model_set_hash(hs) == jpacks.model_set_hash(hs)
    assert packs.pack_max() == jpacks.pack_max()
    assert packs.member_bytes_cap() == jpacks.member_bytes_cap()


def test_pack_warmup_and_residency(docs):
    qs = [_port(docs[k]) for k in ("gbm0", "votes")]
    pack = packs.build_pack(qs, ["a", "b"])
    assert pack.warmup() >= 0.0
    assert pack.resident_bytes == pack.buffer_bytes + sum(
        packs.param_bytes(q) for q in qs)
    assert pack.model_hash.startswith("pack-")
