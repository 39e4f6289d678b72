"""Scoring output types (copy of ``flink_jpmml_tpu/models``)."""
