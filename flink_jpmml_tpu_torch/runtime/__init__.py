"""Streaming runtime of the port: the overlapped CUDA dispatch window
(``pipeline.py``), the block pipeline (``block.py``) and the record engine
(``engine.py``) with its queue, sources and sinks."""
