"""PMML IR → PyTorch lowering: the dense f32 tree path and the rank wire."""

from flink_jpmml_tpu_torch.compile.compiler import CompiledModel, compile_pmml  # noqa: F401
from flink_jpmml_tpu_torch.compile.common import ModelOutput  # noqa: F401
