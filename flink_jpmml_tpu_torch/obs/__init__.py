"""Observability planes of the port: the flight recorder, record trace
contexts, the per-stage ledger (``attr``), and the freshness and pressure
planes that the block pipeline and the Kafka source book into one shared
``MetricsRegistry``."""
