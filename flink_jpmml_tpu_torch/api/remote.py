"""Remote PMML fetching with a validated local cache.

The port's copy of ``flink_jpmml_tpu/api/remote.py``, with the import
lines renamed and one change: the cache lives under the port's own
directory (``utils/cache.py``), ``$FJT_MODEL_CACHE`` or
``~/.cache/flink_jpmml_tpu_torch/models``, never the JAX package's.

The reference read PMML from any Flink filesystem — ``file://``,
``hdfs://``, ``s3://``, ``alluxio://`` …. This module resolves a model
*URI* to a local file the parser can read, caching the bytes on disk and re-validating on each
``load``:

- ``http(s)://`` — stdlib urllib with conditional GET: the cached copy's
  ``ETag``/``Last-Modified`` ride ``If-None-Match``/``If-Modified-Since``,
  so an unchanged model costs one 304 round trip, not a re-download.
- ``gs://`` / ``s3://`` — served through ``google-cloud-storage`` /
  ``boto3`` when installed (optional dependencies); without the
  optional dependency the scheme fails with a typed, actionable error
  instead of an ImportError mid-stream. Object generation/etag is the
  cache validator.
- ``alluxio://`` — the Alluxio proxy REST API (v1): ``get-status``
  supplies the validator (lastModificationTimeMs+length), then
  ``open-file`` → ``streams/{id}/read`` → ``close`` fetches the bytes.
  Proxy REST port defaults to 39999; ``FJT_ALLUXIO_PORT`` overrides
  (URIs copied from client configs usually carry the *master RPC* port
  19998, which does not speak HTTP).
- ``file://`` and bare paths — passed through untouched.

The cache key is the URI's SHA-256, under ``$FJT_MODEL_CACHE`` (default
``~/.cache/flink_jpmml_tpu_torch/models``). ``fetch`` returns
``(local_path, version_token)``; the token changes when the remote object
changes, so ModelReader's compile cache invalidates exactly when the
model does.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import urllib.error
import urllib.parse
import urllib.request
import warnings
from typing import Tuple

from flink_jpmml_tpu_torch.utils.exceptions import ModelLoadingException

_REMOTE_SCHEMES = ("http", "https", "gs", "s3", "hdfs", "alluxio")

# WebHDFS REST port when the hdfs:// URI carries none (Hadoop 3 NameNode
# default); override per deployment with FJT_WEBHDFS_PORT. URIs copied
# from Hadoop configs usually carry the NameNode *RPC* port — those map
# to the REST default rather than speaking HTTP at a protobuf endpoint.
_WEBHDFS_DEFAULT_PORT = 9870
_HDFS_RPC_PORTS = (8020, 9000)

# Alluxio proxy REST port (the master RPC port 19998 does not speak HTTP)
_ALLUXIO_DEFAULT_PORT = 39999
_ALLUXIO_RPC_PORTS = (19998,)


def is_remote(path: str) -> bool:
    return urllib.parse.urlsplit(path).scheme in _REMOTE_SCHEMES


def cache_dir() -> str:
    from flink_jpmml_tpu_torch.utils import cache

    d = os.environ.get("FJT_MODEL_CACHE") or os.path.join(
        cache.cache_dir(), "models"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _cache_paths(uri: str) -> Tuple[str, str]:
    stem = hashlib.sha256(uri.encode()).hexdigest()[:32]
    base = os.path.join(cache_dir(), stem)
    return base + ".pmml", base + ".meta"


def _read_meta(meta_path: str) -> dict:
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _write_atomic(path: str, data: bytes) -> None:
    # unique temp per writer: concurrent workers fetching the same URI
    # (the documented deployment) must not interleave into one temp file
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _serve_stale_or_raise(
    uri: str, local: str, meta_path: str, err, token: str
) -> Tuple[str, str]:
    """Outage policy, shared by every scheme: a cached copy is served
    stale (loudly — an operator must be able to tell workers are running
    a possibly-outdated model, like the reference's workers kept serving
    through DFS blips); no cache → typed error."""
    if os.path.exists(local):
        warnings.warn(
            f"model source {uri!r} unreachable ({err}); serving the "
            "possibly-stale cached copy",
            RuntimeWarning,
            stacklevel=3,
        )
        return local, token
    raise ModelLoadingException(f"cannot fetch model {uri!r}: {err}") from err


def _commit_cache(
    local: str, meta_path: str, token: str, data: bytes, uri: str
) -> Tuple[str, str]:
    """Atomic bytes+meta write, shared by the token-validated schemes."""
    _write_atomic(local, data)
    _write_atomic(meta_path, json.dumps({"token": token, "uri": uri}).encode())
    return local, token


def fetch(uri: str, timeout_s: float = 30.0) -> Tuple[str, str]:
    """Resolve ``uri`` to a local file; → (local_path, version_token).

    Local paths pass through with their mtime as the token. Remote URIs
    are downloaded into the cache (or revalidated against it) and the
    token is the remote object's ETag / Last-Modified / generation."""
    parts = urllib.parse.urlsplit(uri)
    if parts.scheme in ("http", "https"):
        return _fetch_http(uri, timeout_s)
    if parts.scheme == "gs":
        return _fetch_gs(parts)
    if parts.scheme == "s3":
        return _fetch_s3(parts)
    if parts.scheme == "hdfs":
        return _fetch_hdfs(parts, timeout_s)
    if parts.scheme == "alluxio":
        return _fetch_alluxio(parts, timeout_s)
    if parts.scheme == "file":
        local = urllib.request.url2pathname(parts.path)
        return local, str(_mtime(local))
    return uri, str(_mtime(uri))


def _mtime(path: str) -> float:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return -1.0


def _fetch_http(uri: str, timeout_s: float) -> Tuple[str, str]:
    local, meta_path = _cache_paths(uri)
    meta = _read_meta(meta_path) if os.path.exists(local) else {}
    req = urllib.request.Request(uri)
    if meta.get("etag"):
        req.add_header("If-None-Match", meta["etag"])
    if meta.get("last_modified"):
        req.add_header("If-Modified-Since", meta["last_modified"])
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            data = resp.read()
            headers = resp.headers
    except urllib.error.HTTPError as e:
        if e.code == 304:  # cached copy still valid
            return local, meta.get("etag") or meta.get("last_modified") or "cached"
        raise ModelLoadingException(
            f"HTTP {e.code} fetching model {uri!r}"
        ) from e
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return _serve_stale_or_raise(
            uri, local, meta_path, e,
            meta.get("etag") or meta.get("last_modified") or "stale",
        )
    _write_atomic(local, data)
    new_meta = {
        "etag": headers.get("ETag"),
        "last_modified": headers.get("Last-Modified"),
        "uri": uri,
    }
    _write_atomic(meta_path, json.dumps(new_meta).encode())
    token = (
        new_meta["etag"]
        or new_meta["last_modified"]
        or hashlib.sha256(data).hexdigest()[:16]
    )
    return local, token


def _fetch_rest_validated(
    parts,
    timeout_s: float,
    *,
    label: str,
    env_var: str,
    rpc_ports: Tuple[int, ...],
    default_port: int,
    status_token,
    read_bytes,
) -> Tuple[str, str]:
    """Shared scaffold for the REST-gateway filesystems (WebHDFS,
    Alluxio proxy): resolve the REST port (env override wins; a known
    RPC port in the URI remaps to the gateway default), validate the
    cache with ``status_token(host, port) -> token``, fetch with
    ``read_bytes(host, port) -> bytes``, and apply the module's shared
    outage ladder (HTTP error → typed; network error → stale-or-raise).
    Keeping ONE ladder means a fix to stale-serving or port parsing
    cannot drift between the two schemes."""
    uri = urllib.parse.urlunsplit(parts)
    local, meta_path = _cache_paths(uri)
    host = parts.hostname or "localhost"
    try:
        env_port = os.environ.get(env_var)
        if env_port is not None:
            port = int(env_port)  # explicit override always wins
        else:
            port = parts.port  # urlsplit defers validation to here
            if port is None or port in rpc_ports:
                port = default_port
    except ValueError as e:
        raise ModelLoadingException(
            f"invalid {label} port for {uri!r}: {e}"
        ) from e
    try:
        token = status_token(host, port)
        meta = _read_meta(meta_path)
        if os.path.exists(local) and meta.get("token") == token:
            return local, token
        data = read_bytes(host, port)
    except urllib.error.HTTPError as e:
        raise ModelLoadingException(
            f"{label} {e.code} fetching model {uri!r}"
        ) from e
    except (
        urllib.error.URLError, OSError, TimeoutError, json.JSONDecodeError,
    ) as e:
        return _serve_stale_or_raise(
            uri, local, meta_path, e,
            _read_meta(meta_path).get("token") or "stale",
        )
    return _commit_cache(local, meta_path, token, data, uri)


def _fetch_hdfs(parts, timeout_s: float) -> Tuple[str, str]:
    """``hdfs://namenode[:port]/path`` via the WebHDFS REST gateway —
    no Hadoop client dependency, plain HTTP against the NameNode:
    GETFILESTATUS supplies the cache validator (modificationTime+length);
    OPEN streams the bytes (follows the DataNode redirect). The REST port
    defaults to 9870 (Hadoop 3) and can be overridden with
    ``FJT_WEBHDFS_PORT`` when the URI gives only the RPC authority."""

    def base(host, port):
        return f"http://{host}:{port}/webhdfs/v1{parts.path}"

    def status_token(host, port):
        with urllib.request.urlopen(
            base(host, port) + "?op=GETFILESTATUS", timeout=timeout_s
        ) as resp:
            status = json.load(resp).get("FileStatus", {})
        return (
            f"{status.get('modificationTime', 0)}-{status.get('length', 0)}"
        )

    def read_bytes(host, port):
        with urllib.request.urlopen(
            base(host, port) + "?op=OPEN", timeout=timeout_s
        ) as resp:  # urllib follows the DataNode 307 redirect
            return resp.read()

    return _fetch_rest_validated(
        parts, timeout_s,
        label="WebHDFS",
        env_var="FJT_WEBHDFS_PORT",
        rpc_ports=_HDFS_RPC_PORTS,
        default_port=_WEBHDFS_DEFAULT_PORT,
        status_token=status_token,
        read_bytes=read_bytes,
    )


def _post_json(url: str, timeout_s: float):
    """Alluxio REST calls are POSTs with empty bodies → parsed JSON
    (or None for an empty 200 body, e.g. stream close)."""
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        body = resp.read()
    return json.loads(body) if body else None


def _fetch_alluxio(parts, timeout_s: float) -> Tuple[str, str]:
    """``alluxio://master[:port]/path`` via the Alluxio proxy REST API
    (v1) — no Alluxio client dependency: ``paths/{p}/get-status``
    supplies the cache validator, ``paths/{p}/open-file`` opens a read
    stream whose id feeds ``streams/{id}/read`` (bytes) and
    ``streams/{id}/close``. The proxy REST port defaults to 39999 and
    can be overridden with ``FJT_ALLUXIO_PORT`` when the URI carries the
    master RPC authority (19998)."""
    path_enc = urllib.parse.quote(parts.path, safe="/")

    def base(host, port):
        return f"http://{host}:{port}/api/v1"

    def status_token(host, port):
        status = _post_json(
            f"{base(host, port)}/paths/{path_enc}/get-status", timeout_s
        ) or {}
        return (
            f"{status.get('lastModificationTimeMs', 0)}-"
            f"{status.get('length', 0)}"
        )

    def read_bytes(host, port):
        root = base(host, port)
        sid = _post_json(f"{root}/paths/{path_enc}/open-file", timeout_s)
        req = urllib.request.Request(
            f"{root}/streams/{sid}/read", data=b"", method="POST"
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            data = resp.read()
        try:
            _post_json(f"{root}/streams/{sid}/close", timeout_s)
        except (urllib.error.URLError, OSError, TimeoutError):
            pass  # bytes are already in hand; a leaked stream id times out
        return data

    return _fetch_rest_validated(
        parts, timeout_s,
        label="Alluxio REST",
        env_var="FJT_ALLUXIO_PORT",
        rpc_ports=_ALLUXIO_RPC_PORTS,
        default_port=_ALLUXIO_DEFAULT_PORT,
        status_token=status_token,
        read_bytes=read_bytes,
    )


def _fetch_gs(parts) -> Tuple[str, str]:
    try:
        from google.cloud import storage  # type: ignore
    except ImportError as e:
        raise ModelLoadingException(
            "gs:// model paths need the optional dependency "
            "google-cloud-storage (pip install google-cloud-storage)"
        ) from e
    uri = urllib.parse.urlunsplit(parts)
    local, meta_path = _cache_paths(uri)
    try:
        client = storage.Client()
        blob = client.bucket(parts.netloc).get_blob(parts.path.lstrip("/"))
        if blob is None:
            raise ModelLoadingException(f"no such object: {uri!r}")
        token = str(blob.generation)
        meta = _read_meta(meta_path)
        if os.path.exists(local) and meta.get("token") == token:
            return local, token
        data = blob.download_as_bytes()
    except ModelLoadingException:
        raise
    except Exception as e:  # credentials, network, API errors → typed
        raise ModelLoadingException(
            f"gs fetch failed for {uri!r}: {e}"
        ) from e
    return _commit_cache(local, meta_path, token, data, uri)


def _fetch_s3(parts) -> Tuple[str, str]:
    try:
        import boto3  # type: ignore
    except ImportError as e:
        raise ModelLoadingException(
            "s3:// model paths need the optional dependency boto3 "
            "(pip install boto3)"
        ) from e
    uri = urllib.parse.urlunsplit(parts)
    local, meta_path = _cache_paths(uri)
    try:
        s3 = boto3.client("s3")
        key = parts.path.lstrip("/")
        head = s3.head_object(Bucket=parts.netloc, Key=key)
        token = (
            head.get("ETag", "").strip('"') or str(head.get("LastModified"))
        )
        meta = _read_meta(meta_path)
        if os.path.exists(local) and meta.get("token") == token:
            return local, token
        body = s3.get_object(Bucket=parts.netloc, Key=key)["Body"].read()
    except ModelLoadingException:
        raise
    except Exception as e:  # credentials, network, API errors → typed
        raise ModelLoadingException(
            f"s3 fetch failed for {uri!r}: {e}"
        ) from e
    return _commit_cache(local, meta_path, token, body, uri)
