"""Observability planes of the port: the flight recorder, record trace
contexts, the per-stage ledger (``attr``), the freshness and pressure
planes that the block pipeline and the Kafka source book into one shared
``MetricsRegistry``, and the data-drift plane (``drift``: sampled
feature and prediction sketches, baselines and the PSI monitor)."""
