"""Durable small-file writes: the one copy of the atomic-JSON protocol.

The port's copy of ``flink_jpmml_tpu/utils/diskio.py``, unchanged.

Every cache-dir artifact (autotune configs, the kernel cost ledger, the
cost-model fit) persists through the same sequence the checkpoint
writer (runtime/checkpoint.py) established: temp file in the same
directory → flush + fsync → ``os.replace`` → best-effort directory
fsync, so the name is durable, not just the bytes, and a reader can
never see a torn file. Failures are silent by contract — a read-only
cache dir must not break serving or a sweep.
"""

from __future__ import annotations

import json
import os


def atomic_write_json(path: str, obj, fsync_dir: bool = True) -> bool:
    """Durably replace ``path`` with ``json.dumps(obj)``; → True on
    success, False on any OS failure (tmp file cleaned up either way)."""
    path = str(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    if fsync_dir:
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    return True
