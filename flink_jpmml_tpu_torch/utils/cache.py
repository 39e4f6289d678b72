"""The port's own cache directory, and the device tag its files carry.

Everything the port persists between processes lives under
``~/.cache/flink_jpmml_tpu_torch/``: the adaptive batcher's capacity
model (``serving/overload.py``) and, in ``models/``, the remote model
cache (``api/remote.py``, where ``FJT_MODEL_CACHE`` overrides it). The
JAX package's ``~/.cache/flink_jpmml_tpu/`` is never read or written: a
fit made for a TPU, the CPU or another card must not steer this one.

A measurement of the hardware is keyed by :func:`device_tag`: the CUDA
device's name (``torch.cuda.get_device_name``) with every character
outside ``[A-Za-z0-9._-]`` turned into ``_``, or ``cpu``. So a capacity
model fitted on the CPU, or on another kind of card, is never read on
the H100.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Union

CACHE_NAME = "flink_jpmml_tpu_torch"


def cache_dir() -> str:
    """``~/.cache/flink_jpmml_tpu_torch`` (not created here: writers
    create it at their first write)."""
    return os.path.join(os.path.expanduser("~"), ".cache", CACHE_NAME)


def device_tag(device: Optional[Union[str, "torch.device"]] = None) -> str:
    """The file-name tag of ``device`` (a ``torch.device`` or its
    string): ``cpu`` for a CPU device, else the CUDA device's name.
    None means the current CUDA device when there is a card, else
    ``cpu``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return re.sub(r"[^A-Za-z0-9._-]", "_", torch.cuda.get_device_name(dev))


def device_cache_path(stem: str, device=None) -> str:
    """``<cache_dir>/<stem>-<device_tag>.json``: a per-device file."""
    return os.path.join(cache_dir(), f"{stem}-{device_tag(device)}.json")
