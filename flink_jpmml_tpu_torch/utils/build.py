"""Build-and-cache for the port's shared libraries.

Both of the port's native sources, the CUDA kernel
(``csrc/qtrees_ensemble.cu``, by ``nvcc``) and the C++ host data plane
(``_native/fjt_native.cpp``, by ``g++``), are compiled on first use into
:data:`BUILD_DIR` (``build/flink_jpmml_tpu_torch/`` beside the package,
which ``.gitignore`` lists). A library's name carries a hash of its source
and of the compiler's flags, so a changed source or flag is never served
by a stale build. Each process compiles to a temporary name and installs
the library with ``os.replace``, so processes that race the first build
never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
from typing import Optional, Sequence, Type

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG_DIR.parent / "build" / "flink_jpmml_tpu_torch"


def lib_path(
    build_dir: pathlib.Path, stem: str, source: pathlib.Path,
    flags: Sequence[str],
) -> pathlib.Path:
    """``build_dir/<stem>-<hash of source and flags>.so``; raises
    ``OSError`` when the source cannot be read."""
    tag = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return build_dir / f"{stem}-{tag}.so"


def build_shared(
    compiler: str, flags: Sequence[str], source: pathlib.Path,
    path: pathlib.Path, error: Type[Exception], libs: Sequence[str] = (),
) -> Optional[str]:
    """Compile ``source`` into ``path`` (``compiler *flags -o <tmp> source
    *libs``) unless it is there → the compiler's stderr, or None when the
    library was already built. Raises ``error`` carrying the compiler's
    stderr when it fails or cannot be run."""
    if path.exists():
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(source), *libs]
    name = os.path.basename(compiler)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise error(f"{name} invocation failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise error(
            f"{name} failed ({proc.returncode}) on {source}:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return proc.stderr
