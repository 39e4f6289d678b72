"""The multi-tenant zoo in the port (serving/zoo.py and
``DynamicScorer(zoo=)``), held to the JAX package's on the CPU: the
behaviours of the JAX package's tests/test_zoo.py, each on the port, and
the manager's plan, quota and snapshot against the JAX manager's."""

import struct
import time

import numpy as np
import pytest

from flink_jpmml_tpu.models.control import AddMessage as JAdd
from flink_jpmml_tpu.models.core import ModelId as JModelId
from flink_jpmml_tpu.runtime.sources import ControlSource as JControl
from flink_jpmml_tpu.serving.scorer import DynamicScorer as JDynamic
from flink_jpmml_tpu.serving.zoo import ZooManager as JZoo
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer
from flink_jpmml_tpu_torch.serving.zoo import ZooManager
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from test_layouts import stump_forest_xml

BATCH = 32

MVR_XML = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
  <Header/>
  <DataDictionary numberOfFields="3">
    <DataField name="y" optype="continuous" dataType="double"/>
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="b" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TreeModel functionName="regression" missingValueStrategy="defaultChild"
             splitCharacteristic="binarySplit">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a" missingValueReplacement="0.25"/>
      <MiningField name="b"/>
    </MiningSchema>
    <Node id="0" defaultChild="1"><True/>
      <Node id="1" score="1.5">
        <SimplePredicate field="a" operator="lessOrEqual" value="0.1"/>
      </Node>
      <Node id="2" score="-2.0">
        <SimplePredicate field="a" operator="greaterThan" value="0.1"/>
      </Node>
    </Node>
  </TreeModel>
</PMML>"""


def _tenant_docs(tmp_path):
    """name → (path, fields): two GBM shapes, a document with a
    missingValueReplacement, a uint16 stump forest (the JAX test's mix)."""
    g0 = gen_gbm(str(tmp_path), n_trees=3, depth=3, n_features=4, seed=7,
                 name="zg0")
    g1 = gen_gbm(str(tmp_path), n_trees=5, depth=2, n_features=4, seed=8,
                 name="zg1")
    mvr = tmp_path / "mvr.pmml"
    mvr.write_text(MVR_XML)
    wide = tmp_path / "wide.pmml"
    wide.write_text(stump_forest_xml())
    gf = [f"f{j}" for j in range(4)]
    return {"gbm0": (g0, gf), "gbm1": (g1, gf), "mvr": (str(mvr), ["a", "b"]),
            "wide": (str(wide), ["a", "b"])}


def _build(docs, zoo, jax=False, batch=BATCH, metrics=None):
    if jax:
        ctrl = JControl()
        sc = JDynamic(control=ctrl, batch_size=batch, auto_rollout=False,
                      zoo=zoo)
        add, mid_of = JAdd, JModelId
    else:
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=batch, zoo=zoo,
                           device="cpu", metrics=metrics)
        add, mid_of = AddMessage, ModelId
    for name, (path, _) in docs.items():
        ctrl.push(add(name, 1, path, timestamp=time.time()))
    sc._drain_control()
    deadline = time.monotonic() + 300.0
    for name in docs:
        mid = mid_of(name, 1)
        while sc.registry.model_if_warm(mid) is None:
            assert sc.registry.warm_error(mid) is None
            assert time.monotonic() < deadline
            time.sleep(0.01)
    sc._ctrl = ctrl
    return sc


def _events(docs, rows=BATCH, seed=5):
    """One interleaved multi-tenant submit list with hostile lanes: NaN,
    ±inf and missing keys (the mask, and the MVR tenant's replacement)."""
    rng = np.random.default_rng(seed)
    ev = []
    for name, (_, fields) in docs.items():
        for i in range(rows):
            rec = dict(zip(fields, rng.normal(0.0, 1.5, len(fields)).tolist()))
            k = i % 5
            if k == 1:
                rec[fields[i % len(fields)]] = float("nan")
            elif k == 2:
                rec[fields[i % len(fields)]] = float("inf")
            elif k == 3:
                rec[fields[i % len(fields)]] = float("-inf")
            elif k == 4:
                del rec[fields[i % len(fields)]]
            rec["_key"] = f"{name}-{i}"
            ev.append((name, rec))
    by_t = [ev[t * rows:(t + 1) * rows] for t in range(len(docs))]
    return [e for row in zip(*by_t) for e in row]


def _sig(p):
    if p.is_empty:
        return b"empty"
    t = p.target
    return (struct.pack("<d", float(p.score.value)),
            None if t is None else repr(t))


def _run(sc, ev):
    return [_sig(p) for p, _ in sc.finish(sc.submit(ev))]


def _counters(sc):
    return sc.metrics.struct_snapshot()["counters"]


# -- packed against solo -------------------------------------------------------


def test_byte_identity_hostile_lanes_mixed_wires(tmp_path):
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    docs = _tenant_docs(tmp_path)
    sc_zoo = _build(docs, zoo=True)
    sc_solo = _build(docs, zoo=False)
    packed0 = qtrees_cuda.leaf_rows_packed.launches
    for rnd in range(3):
        ev = _events(docs, seed=5 + rnd)
        assert _run(sc_zoo, ev) == _run(sc_solo, ev), rnd
    c = _counters(sc_zoo)
    assert c.get("pack_dispatches", 0) > 0
    for name in docs:
        assert c.get(f'tenant_records{{model="{name}_1"}}', 0) > 0
        assert c.get(f'tenant_records{{model="{name}_1"}}') == \
            BATCH * 3
    hist = sc_zoo.metrics.struct_snapshot()["histograms"]
    assert any(k.startswith("tenant_latency_s") for k in hist)
    # on the CPU the packed launch is its plain version: no card launch
    assert qtrees_cuda.leaf_rows_packed.launches == packed0
    assert not _counters(sc_solo).get("pack_dispatches")


def test_zoo_predictions_agree_with_the_jax_zoo(tmp_path):
    docs = _tenant_docs(tmp_path)
    sc = _build(docs, zoo=True)
    jsc = _build(docs, zoo=True, jax=True)
    ev = _events(docs, seed=17)
    got = sc.finish(sc.submit(ev))
    ref = jsc.finish(jsc.submit(ev))
    for (p, _), (r, _) in zip(got, ref):
        assert p.is_empty == r.is_empty
        if not p.is_empty:
            assert p.score.value == pytest.approx(r.score.value, rel=1e-4,
                                                  abs=1e-5)
    assert _counters(sc).get("pack_dispatches") == \
        jsc.metrics.struct_snapshot()["counters"].get("pack_dispatches")


def test_pack_mixes_uint8_and_uint16_wires(tmp_path):
    docs = _tenant_docs(tmp_path)
    sc = _build(docs, zoo=True)
    _run(sc, _events(docs))
    resident = list(sc._zoo._resident.values())
    assert resident
    widened = [pk for pk in resident if pk.in_dtype is np.uint16
               and any(i["dtype"] is np.uint8 for i in pk._infos)]
    assert widened
    routes = {i["route"] for pk in resident for i in pk._infos}
    assert routes == {"cuda", "torch"}


def test_identity_across_eviction_churn(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_PACK_MAX", "2")
    monkeypatch.setenv("FJT_ZOO_BYTES", "1")
    monkeypatch.setenv("FJT_AUTOTUNE_DISABLE", "1")
    docs = _tenant_docs(tmp_path)
    sc_zoo = _build(docs, zoo=True)
    sc_solo = _build(docs, zoo=False)
    ev = _events(docs, seed=9)
    want = _run(sc_solo, ev)
    assert _run(sc_zoo, ev) == want
    assert _run(sc_zoo, ev) == want
    c = _counters(sc_zoo)
    assert c.get("pack_dispatches", 0) > 0
    assert c.get("zoo_evictions", 0) > 0
    assert c.get("warm_pool_hits", 0) > 0


def test_hog_sheds_neighbours_unharmed(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_TENANT_QUOTA_FRAC", "0.25")
    docs = _tenant_docs(tmp_path)
    docs = {k: docs[k] for k in ("gbm0", "gbm1")}
    sc = _build(docs, zoo=True)
    quota = max(1, int(0.25 * BATCH))
    rng = np.random.default_rng(3)
    ev = []
    for tenant, n in (("gbm0", BATCH), ("gbm1", quota)):
        for i in range(n):
            rec = {f"f{j}": float(v) for j, v in enumerate(rng.normal(size=4))}
            rec["_key"] = f"{tenant}-{i}"
            ev.append((tenant, rec))
    out = sc.finish(sc.submit(ev))
    hog = [p for p, (_, r) in out if r["_key"].startswith("gbm0")]
    mouse = [p for p, (_, r) in out if r["_key"].startswith("gbm1")]
    assert sum(1 for p in hog if not p.is_empty) == quota
    assert sum(1 for p in hog if p.is_empty) == BATCH - quota
    assert all(not p.is_empty for p in mouse)
    c = _counters(sc)
    assert c.get('tenant_shed_records{model="gbm0_1"}', 0) == BATCH - quota
    assert c.get('tenant_shed_records{model="gbm1_1"}', 0) == 0


def test_a_device_fault_on_a_pack_redispatches_and_parity_holds(tmp_path):
    from flink_jpmml_tpu_torch.runtime import faults

    docs = _tenant_docs(tmp_path)
    sc_zoo = _build(docs, zoo=True)
    sc_solo = _build(docs, zoo=False)
    ev = _events(docs, seed=21)
    want = _run(sc_solo, ev)
    try:
        faults.inject("device_error", site="device_readback", n=1)
        got = _run(sc_zoo, ev)
        fired = faults.stats()
    finally:
        faults.clear()
    assert fired == {"device_error": 1}
    assert got == want
    c = _counters(sc_zoo)
    assert c.get("pack_dispatches", 0) > 0
    assert c.get("redispatch_records", 0) > 0


# -- the plan ------------------------------------------------------------------


def test_tenant_add_and_del_invalidate_the_adopted_plan(tmp_path):
    docs = _tenant_docs(tmp_path)
    three = {k: docs[k] for k in ("gbm0", "gbm1", "mvr")}
    sc = _build(three, zoo=True)
    _run(sc, _events(three))
    zoo = sc._zoo
    groups1 = dict(zoo._plan_groups)
    assert not zoo._plan_dirty and zoo.tenant_count() == 3
    # Add: a new tenant joins the next batch's plan
    sc._ctrl.push(AddMessage("wide", 1, docs["wide"][0],
                             timestamp=time.time()))
    sc._drain_control()
    while sc.registry.model_if_warm(ModelId("wide", 1)) is None:
        time.sleep(0.01)
    _run(sc, _events(docs))
    assert zoo.tenant_count() == 4 and "wide_1" in zoo._plan_groups
    assert zoo._plan_groups != groups1
    # Del: the dead tenant leaves the plan and every resident pack
    sc._ctrl.push(DelMessage("wide", 1, timestamp=time.time()))
    _run(sc, _events(three))
    assert zoo.tenant_count() == 3
    assert "wide_1" not in zoo._plan_groups
    assert all("wide_1" not in gk for gk in zoo._resident)
    assert dict(zoo._plan_groups) == groups1


class _Scorer:
    """A member as the manager sees it: a model hash and its meta."""

    def __init__(self, h, trees):
        self.model_hash = h
        self._meta = {"trees": float(trees), "splits": float(trees * 7),
                      "leaves": 8.0, "fields": 4.0, "batch": 32.0,
                      "dtype_rank": 1.0, "classification": 0.0}


def test_manager_plan_quota_and_snapshot_equal_the_jax_manager(
        tmp_path, monkeypatch):
    """Same observe / sync sequence through both managers (each over its
    own autotune cache): the same groups, quota and snapshot counts."""
    monkeypatch.setenv("FJT_TENANT_QUOTA_FRAC", "0.3")
    members = {f"t{i}": _Scorer(f"h{i % 3}", 3 + i) for i in range(6)}
    plans = []
    for Zoo, cache in ((ZooManager, "port.json"), (JZoo, "jax.json")):
        monkeypatch.setenv("FJT_AUTOTUNE_CACHE", str(tmp_path / cache))
        zoo = Zoo()
        for k, q in members.items():
            zoo.observe(k, q)
        zoo._replan()
        first = dict(zoo._plan_groups)
        zoo.sync({"t0", "t1", "t2", "t4"})
        assert zoo._plan_dirty
        zoo._replan()
        plans.append((first, dict(zoo._plan_groups), zoo.quota_rows(100),
                      zoo.quota_rows(2), zoo.tenant_count(),
                      {k: v for k, v in zoo.snapshot().items()
                       if k != "groups"}))
    assert plans[0] == plans[1]
    assert plans[0][2] == 30 and plans[0][3] == 1


def test_quota_is_off_without_the_knob():
    assert ZooManager().quota_rows(BATCH) is None
