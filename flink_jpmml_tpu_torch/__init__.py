"""PyTorch/CUDA port of ``flink_jpmml_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's module paths, so that each module's
counterpart is found under the same name. It imports ``torch`` and never
``jax``, and nothing of ``flink_jpmml_tpu`` (whose ``__init__`` pulls in
jax): what it needs of the numpy-only modules it keeps as its own copies.

Device policy: every entry point (``compile.compile_pmml``,
``CompiledModel.quantized_scorer``, ``runtime.block.BlockPipeline``) runs
on the CUDA card unless the caller passes ``device="cpu"``. Without a card
and without that request it raises
:class:`~flink_jpmml_tpu_torch.utils.exceptions.DeviceUnavailableError`;
it never carries on on the CPU by itself (``utils/device.py``).
"""
