"""Observability planes of the port: the flight recorder, record trace
contexts, the per-stage ledger (``attr``), the freshness and pressure
planes that the block pipeline and the Kafka source book into one shared
``MetricsRegistry``, the data-drift plane (``drift``: sampled
feature and prediction sketches, baselines and the PSI monitor), the
stdlib-HTTP exposition (``server``: ``/metrics``, ``/healthz``,
``/varz``, ``/history``, ``/trace``) and durable telemetry history
(``history``: delta frames under ``FJT_HISTORY_DIR``)."""

from flink_jpmml_tpu_torch.obs.recorder import FlightRecorder, record  # noqa: F401
from flink_jpmml_tpu_torch.obs.server import ObsServer, prometheus_text  # noqa: F401
