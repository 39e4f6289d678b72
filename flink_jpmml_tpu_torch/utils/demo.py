"""The device bootstrap shared by the ``examples_torch/`` jobs and
``fjt-score``.

The port's twin of ``flink_jpmml_tpu/utils/demo.py``. Both functions keep
their JAX names and flags: ``--platform`` (or the ``FJT_PLATFORM`` env
var) picks where the job runs, and :func:`demo_backend` parses and strips
it from ``sys.argv`` so the example's own parser never sees it.

What differs is the device policy (``utils/device.py``): the card by
default, the CPU only on request, and no fall-back.

- ``cpu`` means the CPU; ``gpu`` and ``cuda`` mean the card. Any other
  value (``tpu``, a JAX platform name) raises ``ValueError``, and so does
  a card by index (``cuda:N``): the jobs and their worker processes run
  on the current card, so an index would be dropped, and a card is
  picked with ``CUDA_VISIBLE_DEVICES`` instead.
- No value means the card through ``resolve_device(None)``, which raises
  ``DeviceUnavailableError`` on a host without one.
- The JAX package arms a watchdog around backend init and, when init
  stalls, re-execs the process onto the CPU. The port has no backend init
  to time and never moves a job to the CPU behind its caller's back, so
  there is no watchdog and no re-exec: ``--backend-timeout`` (and
  ``timeout_s=``) raises ``NotPortedError``.

Both functions return the resolved ``torch.device``'s type, ``"cuda"`` or
``"cpu"``, which every port entry point takes as its ``device=``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import NotPortedError


def platform_device(platform: Optional[str]) -> torch.device:
    """``--platform`` value → the device it names (no value: the card)."""
    if platform is None or platform == "gpu":
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    if platform == "cuda":
        return resolve_device(None)
    if platform.startswith("cuda:"):
        raise ValueError(
            f"platform {platform!r} names a card by index, which the port "
            f"does not take: pass 'cuda' and pick the card with "
            f"CUDA_VISIBLE_DEVICES"
        )
    raise ValueError(
        f"unknown platform {platform!r}: the port runs on 'cpu' or the "
        f"card ('gpu', 'cuda')"
    )


def resolve_backend(
    platform: Optional[str], timeout_s: Optional[float] = None
) -> str:
    """Resolve ``platform`` (falling back to ``FJT_PLATFORM``) to a
    device → its type. ``timeout_s`` would arm the JAX package's
    init watchdog and its re-exec onto the CPU, which the port does not
    carry."""
    if timeout_s is not None:
        raise NotPortedError(
            "--backend-timeout is not ported: it arms the JAX package's "
            "backend-init watchdog, which re-execs the process onto the "
            "CPU; the port runs where --platform says or raises"
        )
    platform = platform or os.environ.get("FJT_PLATFORM") or None
    return platform_device(platform).type


def demo_backend() -> str:
    """Resolve the device for an example job.

    Parses (and strips from ``sys.argv``) the shared ``--platform`` /
    ``--backend-timeout`` flags, then defers to :func:`resolve_backend`.
    Returns ``"cuda"`` or ``"cpu"``.
    """
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--backend-timeout", type=float, default=None)
    args, rest = ap.parse_known_args(sys.argv[1:])
    sys.argv = [sys.argv[0]] + rest
    return resolve_backend(args.platform, args.backend_timeout)
