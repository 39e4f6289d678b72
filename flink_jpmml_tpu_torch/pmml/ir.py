"""Typed IR for PMML 4.x documents.

A copy of ``flink_jpmml_tpu/pmml/ir.py``, kept so that the PyTorch port imports
nothing of the JAX package; the two must parse and prepare alike
(tests/test_torch_frontend.py).

Replaces the JAXB object tree of ``jpmml-model`` (reference layer EXT-B,
SURVEY.md §2) with plain frozen dataclasses. Only the subset of PMML the
capability contract requires is modelled (SURVEY.md §1 C1): DataDictionary,
MiningSchema, TransformationDictionary (a pragmatic expression subset),
Targets, and the five model families — TreeModel, RegressionModel,
NeuralNetwork, ClusteringModel, MiningModel (all segmentation modes incl.
``modelChain``). Unknown elements are ignored by the parser; unsupported
*semantics* (e.g. an activation we can't lower) raise at parse/compile time,
never silently misevaluate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Data dictionary / mining schema
# ---------------------------------------------------------------------------

CONTINUOUS = "continuous"
CATEGORICAL = "categorical"
ORDINAL = "ordinal"


@dataclass(frozen=True)
class Interval:
    """Declared valid range of a continuous DataField (PMML <Interval>).

    ``closure`` ∈ openOpen | openClosed | closedOpen | closedClosed;
    a missing margin means unbounded on that side."""

    closure: str
    left: Optional[float] = None
    right: Optional[float] = None

    def contains(self, x: float) -> bool:
        if self.left is not None:
            if self.closure.startswith("open"):
                if not x > self.left:
                    return False
            elif not x >= self.left:
                return False
        if self.right is not None:
            if self.closure.endswith("Open"):
                if not x < self.right:
                    return False
            elif not x <= self.right:
                return False
        return True


@dataclass(frozen=True)
class DataField:
    name: str
    optype: str  # continuous | categorical | ordinal
    dtype: str  # double | float | integer | string | boolean
    values: Tuple[str, ...] = ()  # declared categories, in document order
    intervals: Tuple[Interval, ...] = ()  # declared valid ranges

    @property
    def is_categorical(self) -> bool:
        return self.optype in (CATEGORICAL, ORDINAL)


@dataclass(frozen=True)
class DataDictionary:
    fields: Tuple[DataField, ...]

    def field(self, name: str) -> DataField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)


@dataclass(frozen=True)
class MiningField:
    name: str
    usage_type: str = "active"  # active | target | predicted | supplementary
    missing_value_replacement: Optional[str] = None
    invalid_value_treatment: str = "returnInvalid"
    invalid_value_replacement: Optional[str] = None  # for asValue


@dataclass(frozen=True)
class MiningSchema:
    fields: Tuple[MiningField, ...]

    @property
    def active_fields(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.usage_type == "active")

    @property
    def target_field(self) -> Optional[str]:
        for f in self.fields:
            if f.usage_type in ("target", "predicted"):
                return f.name
        return None


# ---------------------------------------------------------------------------
# Expressions (TransformationDictionary / DerivedField subset)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldRef:
    field: str


@dataclass(frozen=True)
class Constant:
    value: float


@dataclass(frozen=True)
class LinearNorm:
    orig: float
    norm: float


@dataclass(frozen=True)
class NormContinuous:
    """Piecewise-linear normalization of a continuous field."""

    field: str
    norms: Tuple[LinearNorm, ...]
    outliers: str = "asIs"  # asIs | asMissingValues | asExtremeValues
    map_missing_to: Optional[float] = None


@dataclass(frozen=True)
class NormDiscrete:
    """One-hot indicator: 1.0 when ``field == value`` else 0.0."""

    field: str
    value: str
    map_missing_to: Optional[float] = None


@dataclass(frozen=True)
class Apply:
    """Built-in function application over sub-expressions.

    Supported functions: + - * / min max pow exp ln sqrt abs floor ceil
    threshold if (3-arg) equal lessThan greaterThan and or not.
    """

    function: str
    args: Tuple["Expression", ...]
    map_missing_to: Optional[float] = None


Expression = Union[FieldRef, Constant, NormContinuous, NormDiscrete, Apply]


@dataclass(frozen=True)
class DerivedField:
    name: str
    optype: str
    dtype: str
    expression: Expression


@dataclass(frozen=True)
class TransformationDictionary:
    derived_fields: Tuple[DerivedField, ...] = ()


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimplePredicate:
    field: str
    operator: str  # equal notEqual lessThan lessOrEqual greaterThan
    #               greaterOrEqual isMissing isNotMissing
    value: Optional[str] = None


@dataclass(frozen=True)
class SimpleSetPredicate:
    field: str
    boolean_operator: str  # isIn | isNotIn
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CompoundPredicate:
    boolean_operator: str  # and | or | xor | surrogate
    predicates: Tuple["Predicate", ...] = ()


@dataclass(frozen=True)
class TruePredicate:
    pass


@dataclass(frozen=True)
class FalsePredicate:
    pass


Predicate = Union[
    SimplePredicate, SimpleSetPredicate, CompoundPredicate, TruePredicate, FalsePredicate
]


# ---------------------------------------------------------------------------
# TreeModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScoreDistribution:
    value: str
    record_count: float
    confidence: Optional[float] = None
    probability: Optional[float] = None


@dataclass(frozen=True)
class TreeNode:
    predicate: Predicate
    score: Optional[str] = None
    node_id: Optional[str] = None
    record_count: Optional[float] = None
    default_child: Optional[str] = None
    children: Tuple["TreeNode", ...] = ()
    score_distribution: Tuple[ScoreDistribution, ...] = ()

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclass(frozen=True)
class TreeModelIR:
    function_name: str  # regression | classification
    mining_schema: MiningSchema
    root: TreeNode
    missing_value_strategy: str = "none"
    # none | defaultChild | lastPrediction | nullPrediction | weightedConfidence
    no_true_child_strategy: str = "returnNullPrediction"
    split_characteristic: str = "binarySplit"
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# RegressionModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NumericPredictor:
    name: str
    coefficient: float
    exponent: float = 1.0


@dataclass(frozen=True)
class CategoricalPredictor:
    name: str
    value: str
    coefficient: float


@dataclass(frozen=True)
class RegressionTable:
    intercept: float
    target_category: Optional[str] = None
    numeric_predictors: Tuple[NumericPredictor, ...] = ()
    categorical_predictors: Tuple[CategoricalPredictor, ...] = ()


@dataclass(frozen=True)
class RegressionModelIR:
    function_name: str  # regression | classification
    mining_schema: MiningSchema
    normalization_method: str  # none simplemax softmax logit exp cauchit cloglog
    tables: Tuple[RegressionTable, ...]
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# NeuralNetwork
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NeuralInput:
    neuron_id: str
    derived_field: DerivedField


@dataclass(frozen=True)
class Neuron:
    neuron_id: str
    bias: float
    weights: Tuple[Tuple[str, float], ...]  # (from_neuron_id, weight)
    width: Optional[float] = None  # radialBasis RBF width override
    altitude: Optional[float] = None  # radialBasis altitude override


@dataclass(frozen=True)
class NeuralLayer:
    neurons: Tuple[Neuron, ...]
    activation: Optional[str] = None  # overrides model default
    normalization: Optional[str] = None  # softmax | simplemax
    threshold: Optional[float] = None  # threshold activation cut
    width: Optional[float] = None
    altitude: Optional[float] = None


@dataclass(frozen=True)
class NeuralOutput:
    output_neuron: str
    derived_field: DerivedField  # maps network output back to target space


@dataclass(frozen=True)
class NeuralNetworkIR:
    function_name: str
    mining_schema: MiningSchema
    activation_function: str  # logistic | tanh | identity | rectifier | …
    inputs: Tuple[NeuralInput, ...]
    layers: Tuple[NeuralLayer, ...]
    outputs: Tuple[NeuralOutput, ...]
    normalization_method: str = "none"
    model_name: Optional[str] = None
    threshold: float = 0.0  # threshold-activation cut (spec default 0)
    width: Optional[float] = None  # radialBasis defaults
    altitude: float = 1.0


# ---------------------------------------------------------------------------
# ClusteringModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Cluster:
    center: Tuple[float, ...]
    name: Optional[str] = None
    cluster_id: Optional[str] = None


@dataclass(frozen=True)
class ClusteringField:
    field: str
    weight: float = 1.0
    compare_function: Optional[str] = None  # absDiff | gaussSim | delta | equal
    similarity_scale: Optional[float] = None  # gaussSim scale s


@dataclass(frozen=True)
class ComparisonMeasure:
    kind: str  # distance | similarity
    metric: str  # distance: squaredEuclidean euclidean cityBlock chebychev
    #            minkowski; similarity: simpleMatching jaccard tanimoto
    #            binarySimilarity
    compare_function: str = "absDiff"
    minkowski_p: float = 2.0  # <minkowski p-parameter=…/>
    # binarySimilarity numerator/denominator weights over the (a,b,c,d)
    # contingency counts: (c00, c01, c10, c11, d00, d01, d10, d11)
    binary_params: Tuple[float, ...] = ()


@dataclass(frozen=True)
class ClusteringModelIR:
    function_name: str  # clustering
    mining_schema: MiningSchema
    model_class: str  # centerBased
    measure: ComparisonMeasure
    clustering_fields: Tuple[ClusteringField, ...]
    clusters: Tuple[Cluster, ...]
    # <MissingValueWeights>: opts into missing-field adjustment — terms
    # for missing fields drop out and sum-based metrics rescale by
    # Σq / Σ_nonmissing q. Empty = strict (any missing ⇒ empty lane).
    missing_value_weights: Tuple[float, ...] = ()
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# Scorecard
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScorecardAttribute:
    """One bin of a Characteristic: first-true predicate wins its
    partialScore (UNKNOWN predicates don't match — scorecard documents
    bin missing values with explicit isMissing attributes).

    ``partial_expr`` (ComplexPartialScore) computes the partial from the
    record instead of the static ``partial_score``; a failed/missing
    computation on a chosen attribute empties the lane."""

    predicate: Predicate
    partial_score: float
    reason_code: Optional[str] = None  # overrides the characteristic's
    partial_expr: Optional[Expression] = None


@dataclass(frozen=True)
class Characteristic:
    name: Optional[str]
    attributes: Tuple[ScorecardAttribute, ...]
    reason_code: Optional[str] = None
    baseline_score: Optional[float] = None


@dataclass(frozen=True)
class ScorecardIR:
    function_name: str  # regression
    mining_schema: MiningSchema
    characteristics: Tuple[Characteristic, ...]
    initial_score: float = 0.0
    use_reason_codes: bool = False
    reason_code_algorithm: str = "pointsBelow"  # | pointsAbove
    baseline_score: Optional[float] = None  # model-level default
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# RuleSet
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimpleRule:
    predicate: Predicate
    score: str
    rule_id: Optional[str] = None
    weight: float = 1.0
    confidence: float = 1.0


@dataclass(frozen=True)
class RuleSetIR:
    """PMML RuleSet with flat SimpleRules (nested CompoundRules are
    flattened by the parser into first-hit order)."""

    function_name: str  # classification (regression scores also legal)
    mining_schema: MiningSchema
    rules: Tuple[SimpleRule, ...]
    selection_method: str  # firstHit | weightedSum | weightedMax
    default_score: Optional[str] = None
    default_confidence: float = 0.0
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# GeneralRegressionModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PPCell:
    """One predictor→parameter contribution: for a covariate, ``value``
    is the exponent; for a factor, the category the indicator matches."""

    predictor: str
    parameter: str
    value: str


@dataclass(frozen=True)
class PCell:
    parameter: str
    beta: float
    target_category: Optional[str] = None


@dataclass(frozen=True)
class GeneralRegressionIR:
    """GLM family: x_p = Π covariate^exponent × Π [factor == category];
    η_t = Σ_p β_{t,p} x_p; link applies per modelType."""

    function_name: str
    mining_schema: MiningSchema
    model_type: str  # regression | generalLinear | generalizedLinear |
    #                  multinomialLogistic
    parameters: Tuple[str, ...]  # parameter names, document order
    factors: Tuple[str, ...]  # categorical predictors
    covariates: Tuple[str, ...]  # continuous predictors
    pp_cells: Tuple[PPCell, ...]
    p_cells: Tuple[PCell, ...]
    link_function: Optional[str] = None  # generalizedLinear
    link_power: Optional[float] = None  # for power link
    target_reference_category: Optional[str] = None
    # ordinalMultinomial: cumulative-link name + the ordered category
    # list (the target DataField's declared order, resolved at parse)
    cumulative_link: str = "logit"
    target_categories: Tuple[str, ...] = ()
    # CoxRegression: the record's time field + the fitted baseline
    # cumulative-hazard step function (time, H₀) sorted by time
    end_time_variable: Optional[str] = None
    baseline_cells: Tuple[Tuple[float, float], ...] = ()
    max_time: Optional[float] = None
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# NaiveBayes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BayesCategoricalInput:
    """Per input category: counts of each target value (PairCounts)."""

    field: str
    counts: Tuple[Tuple[str, Tuple[Tuple[str, float], ...]], ...]
    # ((input_value, ((target_value, count), ...)), ...)


@dataclass(frozen=True)
class BayesContinuousInput:
    """Gaussian class-conditional density per target value."""

    field: str
    stats: Tuple[Tuple[str, float, float], ...]  # (target, mean, variance)


@dataclass(frozen=True)
class NaiveBayesIR:
    function_name: str  # classification
    mining_schema: MiningSchema
    inputs: Tuple[Union[BayesCategoricalInput, BayesContinuousInput], ...]
    target_counts: Tuple[Tuple[str, float], ...]  # (target value, count)
    threshold: float  # replaces zero/absent conditional probabilities
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# SupportVectorMachine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SvmKernel:
    kind: str  # linear | polynomial | radialBasis | sigmoid
    gamma: float = 1.0
    coef0: float = 0.0
    degree: float = 1.0


@dataclass(frozen=True)
class SvmMachine:
    """One decision function: f(x) = Σ αᵢ·K(svᵢ, x) + b."""

    vector_ids: Tuple[str, ...]
    coefficients: Tuple[float, ...]
    intercept: float
    target_category: Optional[str] = None
    alternate_target_category: Optional[str] = None
    threshold: Optional[float] = None  # overrides the model's


@dataclass(frozen=True)
class SvmModelIR:
    function_name: str  # classification | regression
    mining_schema: MiningSchema
    kernel: SvmKernel
    vector_fields: Tuple[str, ...]
    vectors: Tuple[Tuple[str, Tuple[float, ...]], ...]  # (id, dense coords)
    machines: Tuple[SvmMachine, ...]
    classification_method: str = "OneAgainstOne"  # | OneAgainstAll
    threshold: float = 0.0
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# NearestNeighborModel (KNN)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KnnInput:
    field: str
    weight: float = 1.0
    compare_function: Optional[str] = None
    similarity_scale: Optional[float] = None


@dataclass(frozen=True)
class NearestNeighborIR:
    """KNN over inline training instances: k smallest comparison-measure
    distances vote/average the stored target values."""

    function_name: str  # classification | regression
    mining_schema: MiningSchema
    n_neighbors: int
    measure: ComparisonMeasure
    inputs: Tuple[KnnInput, ...]
    instances: Tuple[Tuple[float, ...], ...]  # [N][D] feature rows
    targets: Tuple[str, ...]  # [N] target values (labels or numerics)
    continuous_scoring: str = "average"  # | median | weightedAverage
    categorical_scoring: str = "majorityVote"  # | weightedMajorityVote
    # instanceIdVariable: neighbor identities; entityId rank-k outputs
    # surface the kth nearest neighbor's id
    instance_id_variable: Optional[str] = None
    instance_ids: Tuple[str, ...] = ()
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# AnomalyDetectionModel (PMML 4.4)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AnomalyDetectionIR:
    """Wraps an inner model whose raw score becomes the anomaly score.

    ``iforest``: the inner ensemble's mean path length s normalizes to
    2^(−s/c(n)) with n = sampleDataSize and c(n) the average BST
    unsuccessful-search depth. ``ocsvm``/``other``: the inner value
    passes through."""

    function_name: str  # regression
    mining_schema: MiningSchema
    algorithm_type: str  # iforest | ocsvm | other
    inner: "ModelIR"
    sample_data_size: Optional[int] = None
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# GaussianProcessModel (PMML 4.3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GpKernel:
    """One of the four PMML 4.3 GP kernels.

    ``kind``: radialBasis | ARDSquaredExponential | absoluteExponential |
    generalizedExponential. ``lambdas`` holds the length-scale(s): one
    value for the isotropic radialBasis kernel, per-dimension for the
    others (a single value broadcasts)."""

    kind: str
    gamma: float = 1.0
    noise_variance: float = 1.0
    lambdas: Tuple[float, ...] = (1.0,)
    degree: float = 1.0  # generalizedExponential only


@dataclass(frozen=True)
class GaussianProcessIR:
    """GP regression: μ(x) = k(x, X)ᵀ (K + σ²I)⁻¹ y.

    The training instances and targets are stored in the document; the
    regularized inverse is precomputed at compile time (host), leaving a
    kernel-row evaluation + one matvec on the device."""

    function_name: str  # regression
    mining_schema: MiningSchema
    kernel: GpKernel
    inputs: Tuple[str, ...]  # feature fields, instance-column order
    instances: Tuple[Tuple[float, ...], ...]  # [N][D] training rows
    targets: Tuple[float, ...]  # [N] training target values
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# BaselineModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BaselineDistribution:
    """A parametric baseline: gaussian (mean, variance), poisson (mean),
    or uniform (lower, upper)."""

    kind: str  # gaussian | poisson | uniform
    mean: float = 0.0
    variance: float = 1.0
    lower: float = 0.0
    upper: float = 1.0


@dataclass(frozen=True)
class BaselineIR:
    """BaselineModel/TestDistributions with the ``zValue`` statistic:
    score = (x − μ₀) / σ₀ under the baseline distribution (Poisson:
    σ₀² = μ₀). Stateless per record — CUSUM (windowed) is rejected at
    parse time."""

    function_name: str  # regression
    mining_schema: MiningSchema
    field: str
    baseline: BaselineDistribution
    test_statistic: str = "zValue"
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# AssociationModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AssociationRule:
    """antecedent ⊆ basket ⇒ consequent, with the mined statistics."""

    antecedent: Tuple[str, ...]  # item values
    consequent: Tuple[str, ...]
    support: float
    confidence: float
    lift: Optional[float] = None
    rule_id: Optional[str] = None


@dataclass(frozen=True)
class AssociationIR:
    """Association rules over multi-hot basket records.

    The streaming input contract is one active MiningField per item in
    ``items`` (value > 0.5 ⇔ the item is in the record's basket) — the
    fixed-width, TPU-native framing of the reference's group-valued
    transaction field. A rule *fires* when its antecedent is a subset of
    the basket; the per-criterion winner (rule / recommendation /
    exclusiveRecommendation) ranks fired rules by confidence, then
    support, then document order."""

    function_name: str  # associationRules
    mining_schema: MiningSchema
    items: Tuple[str, ...]  # item values, document order
    rules: Tuple[AssociationRule, ...]
    criterion: str = "rule"  # | recommendation | exclusiveRecommendation
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# TextModel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TextModelIR:
    """Document-similarity scoring over a term-frequency input.

    The streaming contract is one active MiningField per term in
    ``terms`` (the record's term counts; missing = 0). Scoring weights
    the query and the stored DocumentTermMatrix rows identically
    (local × global term weights, optional cosine document
    normalization) and predicts the most similar corpus document —
    label = its id, value = the similarity (cosine) or distance
    (euclidean), per-document scores in ``probabilities``."""

    function_name: str  # classification
    mining_schema: MiningSchema
    terms: Tuple[str, ...]
    doc_ids: Tuple[str, ...]
    dtm: Tuple[Tuple[float, ...], ...]  # [D][T] raw counts
    local_weight: str = "termFrequency"  # | binary | logarithmic |
    #                                       augmentedNormalizedTermFrequency
    global_weight: str = "none"  # | inverseDocumentFrequency
    doc_normalization: str = "none"  # | cosine
    similarity: str = "cosine"  # | euclidean
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# BayesianNetworkModel (discrete)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BnNode:
    """One discrete node: P(name | parents) as explicit CPT rows.

    ``cpt`` holds one row per parent configuration: (parent values in
    ``parents`` order, per-state probabilities aligned with ``values``).
    Root nodes have ``parents == ()`` and a single row with an empty
    config."""

    name: str
    values: Tuple[str, ...]
    parents: Tuple[str, ...] = ()
    cpt: Tuple[Tuple[Tuple[str, ...], Tuple[float, ...]], ...] = ()


@dataclass(frozen=True)
class BayesianNetworkIR:
    """Discrete Bayesian network scored under the streaming contract:
    every non-target node is an observed active field (fully observed
    Markov blanket), so the target posterior is closed form —

        P(t | e) ∝ P(t | pa(t)) · Π_{c : t ∈ pa(c)} P(c_obs | pa(c), t)

    — all other factors are observed constants and cancel. Lanes with a
    missing or unmatchable observation score empty (C5)."""

    function_name: str  # classification
    mining_schema: MiningSchema
    nodes: Tuple[BnNode, ...]
    target: str
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# TimeSeriesModel (ExponentialSmoothing, ARIMA)
# ---------------------------------------------------------------------------


# both scoring paths clamp forecast horizons to this (the compiled path
# precomputes ŷ(1..H) as a constant table; the oracle clamps identically
# so parity is total over horizons)
ARIMA_H_MAX = 1024


@dataclass(frozen=True)
class ArimaIR:
    """Fitted (seasonal) ARIMA state, PMML 4.4 ``<ARIMA>``.

    Model (Box–Jenkins sign convention, as the PMML spec writes it):

        φ(B)·Φ(B^s) W_t = c + θ(B)·Θ(B^s) a_t,
        W_t = (1−B)^d (1−B^s)^D z_t,   z = transform(y)

    with φ(B) = 1 − Σφ_i B^i, θ(B) = 1 − Σθ_j B^j (seasonal Φ/Θ alike:
    MA terms SUBTRACT). The document carries the fitted coefficients,
    the most recent residuals a_t (``residuals``, most recent LAST) and
    the observed series (``history``, via ``<TimeSeries>``); scoring is
    the conditional-least-squares forecast recursion at the record's
    horizon h.
    """

    constant: float
    transformation: str  # none | logarithmic | squareroot
    p: int
    d: int
    q: int
    ar: Tuple[float, ...]  # φ_1..φ_p
    ma: Tuple[float, ...]  # θ_1..θ_q
    residuals: Tuple[float, ...]  # a_{T-r+1}..a_T (most recent last)
    sp: int = 0
    sd: int = 0
    sq: int = 0
    period: int = 0
    sar: Tuple[float, ...] = ()  # Φ_1..Φ_P
    sma: Tuple[float, ...] = ()  # Θ_1..Θ_Q
    history: Tuple[float, ...] = ()  # y_1..y_T in time order


@dataclass(frozen=True)
class ExponentialSmoothingIR:
    """Fitted smoothing state: the document stores the final level/trend
    and one period of seasonal factors; scoring is a pure forecast."""

    level: float
    trend: float = 0.0
    # none | additive | damped_additive | multiplicative |
    # damped_multiplicative ("damped_trend" parses as damped_additive)
    trend_type: str = "none"
    phi: float = 1.0  # damped_trend decay
    seasonal_type: str = "none"  # none | additive | multiplicative
    period: int = 0
    seasonal: Tuple[float, ...] = ()  # [period], next slot first


@dataclass(frozen=True)
class TimeSeriesIR:
    """Forecast-at-horizon scoring: the record's ``horizon_field`` value
    h (integer ≥ 1) selects the h-step-ahead forecast. Exactly one of
    ``smoothing`` (bestFit=ExponentialSmoothing:

        ŷ(h) = level (+ h·trend | + trend·φ(1−φ^h)/(1−φ))
                     (± / × seasonal[(h−1) mod period])

    ) or ``arima`` (bestFit=ARIMA: the CLS forecast recursion, see
    :class:`ArimaIR`) is set — the per-record framing of the reference's
    lead-time evaluation (temporal state lives in the document, not the
    stream)."""

    function_name: str  # timeSeries
    mining_schema: MiningSchema
    horizon_field: str
    smoothing: Optional[ExponentialSmoothingIR] = None
    arima: Optional[ArimaIR] = None
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# MiningModel (ensembles / stacking)
# ---------------------------------------------------------------------------

ModelIR = Union[
    TreeModelIR,
    RegressionModelIR,
    NeuralNetworkIR,
    ClusteringModelIR,
    ScorecardIR,
    RuleSetIR,
    GeneralRegressionIR,
    NaiveBayesIR,
    SvmModelIR,
    NearestNeighborIR,
    AnomalyDetectionIR,
    GaussianProcessIR,
    BaselineIR,
    AssociationIR,
    TimeSeriesIR,
    BayesianNetworkIR,
    TextModelIR,
    "MiningModelIR",
]


@dataclass(frozen=True)
class OutputField:
    """PMML <Output>/<OutputField>: post-processing of the model result.

    Used both per-segment (modelChain wiring) and at the document top
    level. ``feature``: predictedValue | probability (``target_value``
    picks the class; absent = the winner's) | transformedValue (whose
    ``expression`` may reference previously computed output fields)."""

    name: str
    feature: str = "predictedValue"  # predictedValue | probability | …
    target_value: Optional[str] = None
    expression: Optional[Expression] = None  # transformedValue only
    rank: int = 1  # reasonCode: 1-based rank into the worst-first list
    rule_feature: Optional[str] = None  # ruleValue (association) only


@dataclass(frozen=True)
class Segment:
    predicate: Predicate
    model: ModelIR
    segment_id: Optional[str] = None
    weight: float = 1.0
    output_fields: Tuple[OutputField, ...] = ()


@dataclass(frozen=True)
class Segmentation:
    multiple_model_method: str
    # sum average weightedAverage majorityVote weightedMajorityVote
    # modelChain selectFirst selectAll(unsupported) max median
    segments: Tuple[Segment, ...]


@dataclass(frozen=True)
class MiningModelIR:
    function_name: str
    mining_schema: MiningSchema
    segmentation: Segmentation
    model_name: Optional[str] = None


# ---------------------------------------------------------------------------
# ModelVerification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VerificationField:
    """One column of the embedded verification table. ``field`` is an
    active input, the target (expected predicted value/label), or a
    ``probability(<class>)`` expectation."""

    field: str
    column: str
    # None = attribute absent from the document: the replay applies its
    # f32-realistic defaults; an explicit producer value is used as-is
    precision: Optional[float] = None
    zero_threshold: Optional[float] = None


@dataclass(frozen=True)
class ModelVerification:
    """Producer-embedded test vectors: inputs + expected outputs. The
    loader replays them through the compiled model and rejects the
    document on mismatch (the JPMML verification contract)."""

    fields: Tuple[VerificationField, ...]
    records: Tuple[Tuple[Tuple[str, str], ...], ...]  # rows of (column, raw)


# ---------------------------------------------------------------------------
# Targets (output rescaling) + document root
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Target:
    field: Optional[str]
    rescale_constant: float = 0.0
    rescale_factor: float = 1.0
    cast_integer: Optional[str] = None  # round | ceiling | floor


@dataclass(frozen=True)
class Header:
    description: Optional[str] = None
    application: Optional[str] = None


@dataclass(frozen=True)
class PmmlDocument:
    version: str
    header: Header
    data_dictionary: DataDictionary
    transformations: TransformationDictionary
    model: ModelIR
    targets: Tuple[Target, ...] = ()
    output_fields: Tuple[OutputField, ...] = ()  # top-level <Output>
    verification: Optional[ModelVerification] = None

    @property
    def active_fields(self) -> Tuple[str, ...]:
        """The model's input contract, in mining-schema order.

        This is what the vector converter validates arity against
        (capability C4): dense vectors zip positionally with these names.
        """
        return _mining_schema_of(self.model).active_fields

    @property
    def target_field(self) -> Optional[str]:
        return _mining_schema_of(self.model).target_field


def _mining_schema_of(model: ModelIR) -> MiningSchema:
    return model.mining_schema
