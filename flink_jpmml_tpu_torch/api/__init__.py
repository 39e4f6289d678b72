"""User-facing API of the port: ``ModelReader`` and the streaming API."""

from flink_jpmml_tpu_torch.api.reader import ModelReader, clear_model_cache  # noqa: F401
from flink_jpmml_tpu_torch.api.stream import EvaluatedStream, Stream, StreamEnvironment  # noqa: F401
