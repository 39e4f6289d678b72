"""Device policy of the port: the card by default, the CPU only on request.

Every entry point resolves its ``device`` argument here. ``None`` means
the CUDA card; without one that raises :class:`DeviceUnavailableError`
instead of carrying on on the CPU. ``"cpu"`` (or any explicit device) is
taken as given — the CPU tests pass it.

Resolving a device also pins float32 matmul precision to "highest" with
TF32 off: the dense tree path's einsums and the rank wire's max/median
and classification contractions are float32 products whose operands must
not be rounded to TF32's 10-bit mantissa (the JAX package uses
``Precision.HIGHEST`` for the same contractions).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError


def pin_float32_precision() -> None:
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` → the current CUDA device, or raise when there is none."""
    pin_float32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is present; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(f"device {dev} requested but CUDA is "
                                     "not available")
    return dev
