"""Streaming runtime of the port: the overlapped CUDA dispatch window
(``pipeline.py``) and the block pipeline (``block.py``)."""
