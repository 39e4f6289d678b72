"""User-facing streaming API (capability C3, SURVEY.md §8 step 6).

The port of ``flink_jpmml_tpu/api/stream.py``. It mirrors the
reference's ``DataStream`` enrichment ergonomics (SURVEY.md §3 row A1
[UNVERIFIED]: ``RichDataStream.evaluate``, quick-evaluate on
``DataStream[Vector]``, ``withSupportStream`` for dynamic serving)
without pretending to be Flink: a :class:`Stream` wraps a source;
``evaluate`` binds a :class:`ModelReader` plus optional extract/emit
shaping; ``to_sink`` completes the dataflow;
:meth:`StreamEnvironment.execute` runs every pipeline to exhaustion
(finite sources) or until stopped.

    env = StreamEnvironment()                  # the card by default
    preds = env.from_collection(records).evaluate(ModelReader(path))
    sink = preds.collect()
    env.execute()

Dynamic serving (C6): ``stream.with_control_stream(ctrl).evaluate()`` —
see :mod:`flink_jpmml_tpu_torch.serving`.

Where it differs: ``StreamEnvironment(config=None, device=None)`` resolves
its device once (``utils/device.resolve_device``: the card by default,
``device="cpu"`` on request) and passes it to every load. Checkpoints are
the JAX package's: ``with_checkpointing(dir)`` or
``RuntimeConfig.checkpoint_dir`` gives a pipeline a ``CheckpointManager``
(and with it the DLQ beside the snapshots and the device-fault ladder),
and ``execute(restore=True)`` / ``start(restore=True)`` resume each
pipeline from its newest snapshot. ``evaluate``'s rollout options
(``guardrails=``, ``key_fn=``) pass through to the dynamic scorer, as in
the JAX package; without a control stream they do nothing, as there.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Union

import torch

from flink_jpmml_tpu_torch.api.reader import ModelReader
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.engine import (
    EmitFn,
    ExtractFn,
    Pipeline,
    Scorer,
    StaticScorer,
)
from flink_jpmml_tpu_torch.runtime.sinks import CollectSink, Sink
from flink_jpmml_tpu_torch.runtime.sources import (
    ControlSource,
    InMemorySource,
    Source,
)
from flink_jpmml_tpu_torch.utils.config import RuntimeConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


class StreamEnvironment:
    """Owns config, device and the pipelines built by the fluent API (the
    ``StreamExecutionEnvironment`` analogue, SURVEY.md §4.5)."""

    def __init__(
        self,
        config: Optional[RuntimeConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config or RuntimeConfig()
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self._pipelines: List[Pipeline] = []

    def from_source(self, source: Source) -> "Stream":
        return Stream(self, source)

    def from_collection(self, records: Sequence[Any], cycle: bool = False) -> "Stream":
        return Stream(self, InMemorySource(records, cycle=cycle))

    def register(self, pipeline: Pipeline) -> Pipeline:
        self._pipelines.append(pipeline)
        return pipeline

    def execute(self, timeout: float = 300.0, restore: bool = False) -> None:
        """Run every registered pipeline until its source is exhausted.

        For unbounded sources use :meth:`start` / :meth:`stop` instead.
        Pipeline failures (ingest or scoring) re-raise here — a dead stream
        is loud, only dirty *records* are silent (C5).
        """
        for p in self._pipelines:
            if restore:
                p.restore()
        errors: List[BaseException] = []

        def _run(p: Pipeline) -> None:
            try:
                p.run_until_exhausted(timeout)
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)

        threads = [
            threading.Thread(target=_run, args=(p,)) for p in self._pipelines
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if errors:
            raise errors[0]

    def start(self, restore: bool = False) -> None:
        for p in self._pipelines:
            if restore:
                p.restore()
            p.start()

    def stop(self) -> None:
        for p in self._pipelines:
            p.stop()
            p.join(timeout=10.0)


@dataclass
class Stream:
    env: StreamEnvironment
    source: Source
    _control: Optional[ControlSource] = None

    def evaluate(
        self,
        reader: ModelReader,
        extract: Optional[ExtractFn] = None,
        emit: Optional[EmitFn] = None,
        replace_nan: Optional[float] = None,
        batch_size: Optional[int] = None,
        guardrails=None,
        key_fn=None,
    ) -> "EvaluatedStream":
        """Score this stream through a PMML model (reference:
        ``stream.evaluate(modelReader) { (event, model) => … }``).

        ``extract`` maps a record batch → feature matrix (default: dict
        records / dense vectors against the model's active fields);
        ``emit`` shapes sink items from (records, predictions). With a
        control stream attached, ``reader`` is the default model (events
        that name no model), and the rest route by name (the
        :class:`~flink_jpmml_tpu_torch.serving.scorer.DynamicScorer`);
        ``guardrails`` (a :class:`~flink_jpmml_tpu_torch.rollout
        .GuardrailSpec`) sets the default health spec for staged rollouts
        pushed on it, and ``key_fn`` derives the canary-split routing key
        per event payload.
        """
        env = self.env
        if self._control is not None:
            from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

            if extract is not None:
                raise ValueError(
                    "extract= is not supported with a control stream: the "
                    "dynamic scorer extracts per served model's field space; "
                    "pass a route= via DynamicScorer directly for custom "
                    "event shapes"
                )
            scorer: Scorer = DynamicScorer(
                control=self._control,
                batch_size=batch_size or env.config.batch.size,
                default_reader=reader,
                replace_nan=replace_nan,
                emit=emit,
                metrics=env.metrics,
                guardrails=guardrails,
                key_fn=key_fn,
                device=env.device,
            )
        else:
            model = reader.load(
                batch_size=batch_size or env.config.batch.size,
                config=env.config.compile,
                device=env.device,
            )
            scorer = StaticScorer(
                model, extract=extract, emit=emit, replace_nan=replace_nan
            )
        return EvaluatedStream(self, scorer)

    def quick_evaluate(
        self,
        reader: ModelReader,
        replace_nan: Optional[float] = None,
        batch_size: Optional[int] = None,
    ) -> "EvaluatedStream":
        """Vector-stream shortcut (reference: quick ``evaluate`` on
        ``DataStream[Vector]`` returning ``(Prediction, inputVector)``)."""
        return self.evaluate(
            reader,
            emit=lambda recs, preds: list(zip(preds, recs)),
            replace_nan=replace_nan,
            batch_size=batch_size,
        )

    def with_control_stream(self, control: ControlSource) -> "Stream":
        """Attach a dynamic-serving control stream (capability C6; the
        reference's ``withSupportStream``)."""
        return Stream(self.env, self.source, _control=control)


@dataclass
class EvaluatedStream:
    stream: Stream
    scorer: Scorer
    _checkpoint_dir: Optional[str] = None

    def with_checkpointing(self, directory: str) -> "EvaluatedStream":
        self._checkpoint_dir = directory
        return self

    def to_sink(self, sink: Sink) -> Pipeline:
        env = self.stream.env
        ckpt_dir = self._checkpoint_dir or env.config.checkpoint_dir
        ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        pipeline = Pipeline(
            source=self.stream.source,
            scorer=self.scorer,
            sink=sink,
            config=env.config,
            metrics=env.metrics,
            checkpoint=ckpt,
        )
        return env.register(pipeline)

    def collect(self) -> CollectSink:
        sink = CollectSink()
        self.to_sink(sink)
        return sink
