"""Dynamic model serving of the port (capability C6): the registry, the
managers, the event ⋈ control join (``DynamicScorer``) and its block-path
twin (``DynamicBlockPipeline``)."""

from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline  # noqa: F401
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry  # noqa: F401
from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer, default_route  # noqa: F401
