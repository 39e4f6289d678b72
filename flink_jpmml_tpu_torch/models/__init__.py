"""Domain types of the port: predictions (a copy), model identity and the
control-stream messages (copies of ``models/core.py`` and
``models/control.py``), re-exported here."""

from flink_jpmml_tpu_torch.models.control import (  # noqa: F401
    AddMessage,
    DelMessage,
    RolloutMessage,
    ServingMessage,
    from_wire,
    to_wire,
)
from flink_jpmml_tpu_torch.models.core import ModelId, ModelInfo  # noqa: F401
