"""Typed failure vocabulary for model load / validate / prepare / extract.

A copy of ``flink_jpmml_tpu/utils/exceptions.py`` (the port imports nothing
of the JAX package), plus the errors the port adds:
:class:`DeviceUnavailableError`, :class:`NotPortedError` and
:class:`NativeBuildError`, and :func:`refuse`, which raises
``NotPortedError`` for an option of the JAX API the port does not carry.

Reference parity: the reference's ``…/exceptions/`` package defines
``ModelLoadingException``, ``InputValidationException``,
``InputPreparationException`` and ``JPMMLExtractionException``
(SURVEY.md §3 row C1 [UNVERIFIED]).

Design difference from the reference: these exceptions are raised only on the
*cold* path (loading, parsing, compiling — where failing loudly is correct).
The *hot* path is total by construction (capability C5): per-record problems
become masked lanes → ``EmptyScore``, never exceptions, because raising from
inside a jitted function is impossible and per-record host checks would
reintroduce the per-record CPU cost the whole design removes.
"""

from __future__ import annotations


class FlinkJpmmlTpuError(Exception):
    """Base class for all framework errors."""


class ModelLoadingException(FlinkJpmmlTpuError):
    """The PMML document could not be read, parsed or version-gated."""


class UnsupportedPmmlVersionException(ModelLoadingException):
    """The document's PMML schema version is outside the supported 4.0–4.4."""


class ModelCompilationException(FlinkJpmmlTpuError):
    """The parsed PMML IR could not be lowered to a device computation."""


class InputValidationException(FlinkJpmmlTpuError):
    """Input arity / dtype does not match the model's active fields.

    Raised at *batch-construction* time (host side, cold shape checks only).
    Per-record value problems (NaNs, out-of-range) never raise — they mask.
    """


class InputPreparationException(FlinkJpmmlTpuError):
    """Field preparation (encoding, coercion) failed on the host side."""


class ExtractionException(FlinkJpmmlTpuError):
    """The model's target value could not be decoded from device output."""


class CheckpointException(FlinkJpmmlTpuError):
    """Writing or restoring a runtime checkpoint failed."""


class ModelVerificationException(ModelLoadingException):
    """The document's embedded ModelVerification records disagree with
    the compiled model's output — the model must not serve."""


class DeviceUnavailableError(FlinkJpmmlTpuError):
    """An entry point was asked for the card (the default) but no CUDA
    device is present. The port never carries on on the CPU unless the
    caller passes ``device="cpu"``."""


class NotPortedError(ModelCompilationException):
    """The document needs a part of the JAX package that the PyTorch
    port does not carry yet (another model family, halting trees,
    derived fields, top-level ``<Output>``)."""


class NativeBuildError(FlinkJpmmlTpuError):
    """The C++ host data plane (``_native/fjt_native.cpp``: the ring and
    the rank-wire bucketizer) could not be built or loaded. The message
    carries g++'s stderr. The port raises it where the JAX package would
    drop to the Python ring or the numpy encode."""


def refuse(**options) -> None:
    """Raise :class:`NotPortedError` naming the first option given a value
    other than None (an option of the JAX API the port does not carry)."""
    for name, value in options.items():
        if value is not None:
            raise NotPortedError(f"{name}= is not ported")
