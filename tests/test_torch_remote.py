"""Remote model paths of the port (``api/remote.py`` and
``ModelReader``) on the CPU against the JAX package's: an ``http://``
model served by a loopback ``http.server`` loads into both readers and
scores the same as the local file, a second load revalidates with a 304
and reuses the compiled model, a changed model recompiles, a stale cache
serves through an outage, the missing-dependency schemes raise the same
typed error, local paths pass through, the port's cache lives in its own
directory, and a ``DynamicScorer`` Add with a remote path serves.

Nothing leaves the loopback interface. The port runs with
``device="cpu"``; values at rtol 1e-4 / atol 1e-5."""

import hashlib
import http.server
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import pytest

from test_torch_checkpoint import B, F, TWINS, data  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5

_CONST_XML = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
  <Header/>
  <DataDictionary numberOfFields="2">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <RegressionModel functionName="regression">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a"/>
    </MiningSchema>
    <RegressionTable intercept="{c}">
      <NumericPredictor name="a" coefficient="0.5"/>
    </RegressionTable>
  </RegressionModel></PMML>"""


def api(name):
    if name == "jax":
        from flink_jpmml_tpu.api import reader, remote
        from flink_jpmml_tpu.utils import exceptions
        kw = {}
    else:
        from flink_jpmml_tpu_torch.api import reader, remote
        from flink_jpmml_tpu_torch.utils import exceptions
        kw = {"device": "cpu"}
    return reader, remote, exceptions, kw


class _CountingHandler(http.server.SimpleHTTPRequestHandler):
    stats = {"GET": 0, "304": 0}

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).stats["GET"] += 1
        super().do_GET()

    def send_response(self, code, *a, **kw):
        if code == 304:
            type(self).stats["304"] += 1
        super().send_response(code, *a, **kw)


@pytest.fixture()
def http_root(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_MODEL_CACHE", str(tmp_path / "cache"))
    for name in TWINS:
        api(name)[0].clear_model_cache()
    docroot = tmp_path / "www"
    docroot.mkdir()
    handler = type("Handler", (_CountingHandler,),
                   {"stats": {"GET": 0, "304": 0}})
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0),
        lambda *a, **kw: handler(*a, directory=str(docroot), **kw),
    )
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield docroot, f"http://127.0.0.1:{srv.server_address[1]}", handler
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _gbm_doc(docroot):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    return pathlib.Path(gen_gbm(str(docroot), n_trees=12, depth=4,
                                n_features=F))


def test_http_gbm_scores_like_the_local_file_in_both(http_root):
    docroot, base, _ = http_root
    local = _gbm_doc(docroot)
    X = data(3 * B, seed=2)
    scores = {}
    for name in TWINS:
        reader, _, _, kw = api(name)
        for where in ("local", "http"):
            path = str(local) if where == "local" else f"{base}/{local.name}"
            cm = reader.ModelReader(path).load(batch_size=B, **kw)
            recs = [{f"f{j}": float(v) for j, v in enumerate(r)
                     if not np.isnan(v)} for r in X]
            scores[name, where] = np.asarray(
                [p.score.value for p in cm.score_records(recs[:B])]
                + [p.score.value for p in cm.score_records(recs[B:2 * B])])
    np.testing.assert_array_equal(scores["port", "http"],
                                  scores["port", "local"])
    np.testing.assert_allclose(scores["port", "http"], scores["jax", "http"],
                               rtol=RTOL, atol=ATOL)


def test_second_load_revalidates_without_recompile_in_both(http_root):
    docroot, base, h = http_root
    (docroot / "m.pmml").write_text(_CONST_XML.format(c=1.0))
    uri = f"{base}/m.pmml"
    got = {}
    for name in TWINS:
        reader, _, _, kw = api(name)
        m1 = reader.ModelReader(uri).load(batch_size=4, **kw)
        gets, n304 = h.stats["GET"], h.stats["304"]
        m2 = reader.ModelReader(uri).load(batch_size=4, **kw)
        got[name] = (m2 is m1, h.stats["GET"] - gets, h.stats["304"] - n304)
    assert got["port"] == got["jax"] == (True, 1, 1)


def test_changed_remote_model_recompiles_in_both(http_root):
    docroot, base, _ = http_root
    p = docroot / "m.pmml"
    p.write_text(_CONST_XML.format(c=1.0))
    uri = f"{base}/m.pmml"
    firsts = {name: api(name)[0].ModelReader(uri).load(
        batch_size=4, **api(name)[3]) for name in TWINS}
    p.write_text(_CONST_XML.format(c=9.0))
    future = time.time() + 5  # Last-Modified has 1 s resolution
    os.utime(p, (future, future))
    for name in TWINS:
        reader, _, _, kw = api(name)
        m2 = reader.ModelReader(uri).load(batch_size=4, **kw)
        assert m2 is not firsts[name]
        [pred] = m2.score_records([{"a": 0.0}])
        assert pred.score.value == pytest.approx(9.0)


def test_stale_cache_serves_through_an_outage_in_both(http_root):
    docroot, base, _ = http_root
    (docroot / "m.pmml").write_text(_CONST_XML.format(c=3.0))
    uri = f"{base}/m.pmml"
    dead = "http://127.0.0.1:1/m.pmml"
    for name in TWINS:
        _, remote, exc, _ = api(name)
        local, token = remote.fetch(uri)
        assert pathlib.Path(local).exists() and token
        with pytest.raises(exc.ModelLoadingException):
            remote.fetch(dead)
        stem = hashlib.sha256(dead.encode()).hexdigest()[:32]
        cdir = remote.cache_dir()
        shutil.copy(local, os.path.join(cdir, stem + ".pmml"))
        with open(os.path.join(cdir, stem + ".meta"), "w") as f:
            json.dump({"etag": "x", "uri": dead}, f)
        with pytest.warns(RuntimeWarning, match="stale"):
            local2, _ = remote.fetch(dead)
        assert pathlib.Path(local2).read_text() == \
            pathlib.Path(local).read_text()
        os.unlink(os.path.join(cdir, stem + ".pmml"))


@pytest.mark.parametrize("uri,match", [
    ("s3://bucket/model.pmml", "boto3"),
    ("hdfs://127.0.0.1:1/m.pmml", None),
    ("alluxio://127.0.0.1:1/m.pmml", None),
])
def test_unusable_schemes_raise_the_same_typed_error(uri, match, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("FJT_MODEL_CACHE", str(tmp_path))
    monkeypatch.setenv("FJT_WEBHDFS_PORT", "1")
    monkeypatch.setenv("FJT_ALLUXIO_PORT", "1")
    msgs = {}
    for name in TWINS:
        _, remote, exc, _ = api(name)
        with pytest.raises(exc.ModelLoadingException,
                           match=match or "") as ei:
            remote.fetch(uri)
        msgs[name] = type(ei.value).__name__
    assert msgs["port"] == msgs["jax"] == "ModelLoadingException"


def test_local_paths_pass_through_in_both(tmp_path):
    p = tmp_path / "m.pmml"
    p.write_text(_CONST_XML.format(c=1.0))
    for name in TWINS:
        _, remote, _, _ = api(name)
        assert remote.fetch(f"file://{p}")[0] == str(p)
        assert remote.fetch(str(p)) == (str(p), str(os.stat(p).st_mtime))
        assert remote.is_remote("http://x/m.pmml")
        assert not remote.is_remote(str(p))


def test_the_ports_model_cache_is_its_own(tmp_path, monkeypatch):
    from flink_jpmml_tpu_torch.api import remote

    monkeypatch.delenv("FJT_MODEL_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    d = remote.cache_dir()
    assert d == os.path.join(str(tmp_path), ".cache",
                             "flink_jpmml_tpu_torch", "models")
    assert os.path.isdir(d)
    assert not os.path.exists(os.path.join(str(tmp_path), ".cache",
                                           "flink_jpmml_tpu"))


def test_dynamic_add_with_a_remote_path_serves(http_root):
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    docroot, base, _ = http_root
    (docroot / "served.pmml").write_text(_CONST_XML.format(c=7.0))
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=4, device="cpu")
    ctrl.push(AddMessage("rm", 1, f"{base}/served.pmml", timestamp=1.0))
    [(p, _)] = sc.finish(sc.submit([("rm", {"a": 2.0})]))
    assert p.score.value == pytest.approx(7.0 + 0.5 * 2.0)
