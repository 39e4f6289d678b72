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

import gc

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
    3 over 4 features, a 3-class vote forest, a 16-class one over 6
    features, a uint16 stump forest."""
    d = str(tmp_path)
    out = {
        f"gbm{i}": (gen_gbm(d, n_trees=t, depth=3, n_features=4, seed=s,
                            name=f"g{i}"), None)
        for i, (t, s) in enumerate(((3, 7), (5, 8), (8, 9)))
    }
    out["votes"] = (gen_vote_forest(d, n_trees=6, depth=3, n_features=4,
                                    n_classes=3, seed=3), None)
    out["votes16"] = (gen_vote_forest(d, n_trees=5, depth=3, n_features=6,
                                      n_classes=16, seed=4, name="v16"),
                      None)
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


def _cdiv(a, b):
    return -(-a // b)


def test_packed_shape_takes_the_smallest_block_and_largest_need():
    # a member of 3 small trees and one of 500 trees over 256 fields: each
    # keeps its own chunk (one table buffer where the chunk is the whole
    # table); the block is the pack's, no larger than twice the smallest
    # member's rows; its shared memory is the largest need at that tile
    small = (4, 3, 8, None, None)
    wide = (256, 500, 200, None, None)
    rows = [100, 3000]
    sh = qc.packed_shape([small, wide], rows, 1)
    chunks = [qc.launch_shape(*m)[1] for m in (small, wide)]
    assert list(sh.chunks) == chunks
    assert sh.bufs == (1, 2)
    assert (sh.threads, sh.records_per_thread) in qc.PACKED_BLOCKS
    assert sh.tile <= 2 * min(rows)
    assert sh.blocks == tuple(_cdiv(r, sh.tile) for r in rows)
    assert sh.smem == max(
        qc.BAR_BYTES + b * c * w * 8 + sh.tile * qc.staged_row_stride(f)
        for (f, _t, w, _, _), c, b in zip([small, wide], chunks, sh.bufs))
    assert sh.smem <= qc.SMEM_MAX
    assert sh.resident == qc.packed_resident(
        sh.threads, sh.records_per_thread, sh.smem, 1)
    # of the blocks that fit, the fewest walks one after another a thread
    # slot takes (waves times records a thread)
    for threads, per_thread in qc.PACKED_BLOCKS:
        tile = threads * per_thread
        smem = max(qc.BAR_BYTES + b * c * w * 8
                   + tile * qc.staged_row_stride(f)
                   for (f, _t, w, _, _), c, b in zip([small, wide], chunks,
                                                     sh.bufs))
        if tile > 2 * min(rows) or smem > qc.SMEM_MAX:
            continue
        slots = qc.SM_COUNT * qc.packed_resident(threads, per_thread, smem, 1)
        waves = _cdiv(sum(_cdiv(r, tile) for r in rows), slots)
        assert waves * per_thread >= (
            _cdiv(sh.n_blocks, sh.slots) * sh.records_per_thread)
    with pytest.raises(ValueError):
        qc.packed_shape([small, (4, 3, 8, 48, None)], [1, 1])  # not a warp
    with pytest.raises(ValueError):
        qc.packed_shape([], [])
    with pytest.raises(ValueError):
        qc.packed_shape([small, wide], [1])
    with pytest.raises(ValueError):
        qc.packed_shape([small] * (qc.MAX_PACK_MEMBERS + 1),
                        [1] * (qc.MAX_PACK_MEMBERS + 1))


# the main path's model (gen_gbm(500, depth=6, n_features=32)): 500 trees
# of 63 splits and 64 leaves, 160 words a tree
MAIN = (32, 500, qc.walk_words(63, 64, 1), None, None)


def test_packed_shape_fills_every_resident_slot_for_eight_main_members():
    sh = qc.packed_shape([MAIN] * 8, [16384] * 8, 1)
    assert sh.n_blocks >= sh.slots == qc.SM_COUNT * sh.resident
    assert sh.resident >= 3  # the solo block's shape holds two an SM
    assert sh.bufs == (2,) * 8  # 500 trees take 27 chunks of 19
    assert sh.smem <= qc.SMEM_MAX


def test_packed_shape_leaves_zoo_blocks_at_least_half_live():
    # the zoo drill's members: 6-15 depth-3 trees over 4 fields
    zoo = [(4, 6 + i % 10, qc.walk_words(7, 8, 1), None, None)
           for i in range(16)]
    sh = qc.packed_shape(zoo, [256] * 16, 1)
    assert sh.bufs == (1,) * 16
    for r, n in zip([256] * 16, sh.blocks):
        for b in range(n):
            assert min(sh.tile, r - b * sh.tile) * 2 >= sh.tile
    # ragged: each member of 64 rows or more has at least half of its
    # blocks' lanes live
    rows = [64, 65, 127, 500, 1, 0, 63, 3000]
    sh = qc.packed_shape(zoo[: len(rows)], rows, 1)
    for r, n in zip(rows, sh.blocks):
        assert n == _cdiv(r, sh.tile)
        if r >= qc.HALF_LIVE_ROWS:
            assert 2 * r >= n * sh.tile


def test_packed_shape_gives_a_one_chunk_member_one_table_buffer():
    one = (4, 12, 40, None, None)
    # the same table in chunks of 5 trees: double buffered
    split = (4, 12, 40, None, 5 * 40 * 8)
    sh1 = qc.packed_shape([one], [256], 1)
    sh2 = qc.packed_shape([split], [256], 1)
    assert (sh1.chunks, sh1.bufs) == ((12,), (1,))
    assert (sh2.chunks, sh2.bufs) == ((5,), (2,))
    assert sh1.tile == sh2.tile
    assert sh1.smem == qc.BAR_BYTES + 12 * 40 * 8 + sh1.tile * 4 * 1
    assert sh2.smem == qc.BAR_BYTES + 2 * 5 * 40 * 8 + sh2.tile * 4 * 1


@pytest.mark.parametrize("threads,per_thread,smem,classes,want", [
    # 57,872 B + 1 KB reserve in 128 B steps: 58,880 B, 3 in 228 KB
    (256, 1, 57872, 1, 3),
    # one-warp blocks: the SM's 32-block limit
    (32, 1, 2544, 1, 32),
    # 85,520 B (the solo block of the main path's model): 2
    (256, 4, 85520, 1, 2),
    # registers: C = 16 at 4 records a thread is capped at 128 a thread,
    # two 256-thread blocks an SM
    (256, 4, 4096, 16, 2),
    (128, 4, 4096, 16, 4),
    # C = 4 at 4 records: 48 registers, five 256-thread blocks
    (256, 4, 4096, 4, 5),
    # threads: eight 256-thread blocks
    (256, 1, 4096, 1, 8),
])
def test_packed_resident_blocks_arithmetic(threads, per_thread, smem,
                                           classes, want):
    assert qc.packed_resident(threads, per_thread, smem, classes) == want


@pytest.mark.parametrize("rows", [
    (0, 1, 31, 32, 33),
    (63, 64, 65, 0, 1, 127),
    (128, 129, 255, 256, 257),
    (511, 512, 513, 1),
    (1023, 1024, 1025, 7, 300),
])
def test_packed_grid_model_covers_every_live_row_once(docs, rows):
    # members cycle a GBM (C = 1), a 3-class and a 16-class vote forest
    names = ("gbm0", "votes", "votes16", "gbm2")
    qs = [_port(docs[names[m % len(names)]]) for m in range(len(rows))]
    tables = [_member_tables(q) for q in qs]
    fields = [len(q.wire.fields) for q in qs]
    N, Bm, F = len(rows), max(rows), max(fields)
    codes = torch.zeros((N, Bm, F), dtype=torch.uint8)
    rows = list(rows)
    dims = qc._packed_members(codes, rows, tables, fields, None)
    shape = qc._packed_shape_of(dims, rows, fields, None)
    assert shape == qc.packed_shape(
        [(f, t["walk"].shape[0], t["walk"].shape[1], None, None)
         for f, t in zip(fields, tables)], rows, 16)
    desc = qc._packed_desc(codes, rows, tables, fields, dims, shape)
    # the model: member m's blocks follow the members' before it, its sums
    # follow theirs, its codes sit in slot m
    classes = [int(t["rows"].shape[2]) for t in tables]
    begin = np.cumsum([0] + [_cdiv(r, shape.tile) for r in rows])
    out_off = np.cumsum([0] + [r * c for r, c in zip(rows, classes)])
    assert desc.shape == (N, qc.DESC_WORDS)
    assert list(desc[:, qc._D_BLOCK_BEGIN]) == list(begin[:-1])
    assert list(desc[:, qc._D_OUT_OFF]) == list(out_off[:-1])
    assert list(desc[:, qc._D_ROWS]) == rows
    assert list(desc[:, qc._D_CODES_OFF]) == [m * Bm * F for m in range(N)]
    assert list(desc[:, qc._D_CLASSES]) == classes
    assert list(desc[:, qc._D_CHUNK_TREES]) == list(shape.chunks)
    assert shape.n_blocks == begin[-1]
    # block -> (member, first row, live rows), the member found as the
    # kernel finds it: the last whose first block is at most the block
    seen = [np.zeros(r, np.int64) for r in rows]
    for b in range(shape.n_blocks):
        lo, hi = 0, N - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if desc[mid, qc._D_BLOCK_BEGIN] <= b:
                lo = mid
            else:
                hi = mid - 1
        first = (b - desc[lo, qc._D_BLOCK_BEGIN]) * shape.tile
        live = min(shape.tile, rows[lo] - first)
        assert 0 < live <= shape.tile
        seen[lo][first: first + live] += 1
    assert all((s == 1).all() for s in seen)
    # and the routed plain version is each member's solo one
    got = qc.leaf_rows_packed(codes, rows, tables, fields)
    for m in range(N):
        solo = qc.leaf_rows_reference(codes[m, : rows[m], : fields[m]]
                                      .contiguous(), tables[m])
        assert got[m].numpy().tobytes() == solo.numpy().tobytes()


def test_packed_plan_is_built_once_and_goes_with_its_tables(docs):
    qs = [_port(docs[k]) for k in ("gbm0", "votes")]
    tables = [_member_tables(q) for q in qs]
    fields = [len(q.wire.fields) for q in qs]
    codes = torch.zeros((2, B, max(fields)), dtype=torch.uint8)
    plan = qc._packed_plan(codes, [B, 5], tables, fields, None)
    assert qc._packed_plan(codes, [B, 5], tables, fields, None) is plan
    assert qc._packed_plan(codes, [B, 6], tables, fields, None) is not plan
    assert plan.out_shape == (B * 1 + 5 * 3,)
    assert plan.args == (2, plan.shape.n_blocks, plan.shape.threads,
                         plan.shape.records_per_thread, plan.shape.smem, 3,
                         qc.SENTINEL)
    assert plan.desc_ptr == plan.desc.ctypes.data
    # a copy of a table is another table; the plans over the first go
    # when it dies
    tables[1] = {k: v.clone() for k, v in tables[1].items()}
    again = qc._packed_plan(codes, [B, 5], tables, fields, None)
    assert again is not plan and again == plan._replace(
        desc=again.desc, desc_ptr=again.desc_ptr)
    del qs
    gc.collect()
    assert all(p is not plan for p in qc._PLANS.values())
    assert qc._packed_plan(codes, [B, 5], tables, fields, None) is again


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
