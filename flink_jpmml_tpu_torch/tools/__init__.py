"""Operator tools of the port, each run as ``python -m
flink_jpmml_tpu_torch.tools.<name>``:

- ``fuzz_soak``: random-model parity soak (compiled model against the
  oracle, seven families) and the chaos soaks (composed faults against
  the Kafka block stream, the multi-tenant zoo, the state-armed
  pipeline's SIGKILLed workers and the degraded mesh), on the card
  unless ``--platform cpu``;
- ``metrics_lint``: every metric name the port registers against the
  operator catalogue (``docs/operations.md``) and the port's own delta
  table (``metric_deltas.md``);
- ``fuzzgen``: the seeded random-model generators and the parity
  assertion that the soak and the tests share.

The twins of the JAX repo's ``tools/fuzz_soak.py`` and
``tools/metrics_lint.py``; the generators are those of its
``tests/test_fuzz.py``."""
