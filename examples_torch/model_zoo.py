"""Example: every supported PMML model family through one streaming run.

Generates a small document per family (the shapes real exporters emit —
R glm/multinom, sklearn IsolationForest, libsvm, credit scorecards…),
streams a batch of records through the runtime against each, and prints
a one-line summary per family. This is the "switching user" tour: the
reference scored any JPMML-supported model class; so does this framework.

The port's twin of ``examples/model_zoo.py``: the same job and flags on
``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, and a host
without one raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/model_zoo.py [--platform cpu]   (or on the card)
"""

import pathlib
import sys
import tempfile

try:  # installed package (pip install -e .)
    import flink_jpmml_tpu_torch  # noqa: F401
except ImportError:  # source checkout without install: add the repo root
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from flink_jpmml_tpu_torch.utils.demo import demo_backend
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.assets_gen import (
    gen_gbm,
    gen_iris_lr,
    gen_kmeans,
    gen_mlp,
    gen_stacked,
)
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

SCORECARD = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="s" optype="continuous" dataType="double"/>
  </DataDictionary>
  <Scorecard functionName="regression" initialScore="500"
      useReasonCodes="true" baselineScore="30">
  <MiningSchema><MiningField name="s" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <Output><OutputField name="rc" feature="reasonCode" rank="1"/></Output>
  <Characteristics>
    <Characteristic name="c0" reasonCode="F0_LOW">
      <Attribute partialScore="50"><SimplePredicate field="f0"
        operator="greaterThan" value="0"/></Attribute>
      <Attribute partialScore="-20"><True/></Attribute>
    </Characteristic>
    <Characteristic name="c1" reasonCode="F1_HIGH">
      <Attribute partialScore="35"><SimplePredicate field="f1"
        operator="lessThan" value="1"/></Attribute>
      <Attribute partialScore="-10"><True/></Attribute>
    </Characteristic>
  </Characteristics></Scorecard></PMML>"""

RULESET = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="accept"/><Value value="review"/><Value value="reject"/>
  </DataField></DataDictionary>
  <RuleSetModel functionName="classification">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <RuleSet defaultScore="review" defaultConfidence="0.5">
    <RuleSelectionMethod criterion="firstHit"/>
    <SimpleRule score="reject" confidence="0.95">
      <CompoundPredicate booleanOperator="and">
        <SimplePredicate field="f0" operator="lessThan" value="-1"/>
        <SimplePredicate field="f1" operator="lessThan" value="0"/>
      </CompoundPredicate></SimpleRule>
    <SimpleRule score="accept" confidence="0.9">
      <SimplePredicate field="f0" operator="greaterThan" value="0.5"/>
    </SimpleRule>
  </RuleSet></RuleSetModel></PMML>"""

GLM = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <GeneralRegressionModel functionName="regression"
      modelType="generalizedLinear" linkFunction="logit">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <ParameterList><Parameter name="p0"/><Parameter name="p1"/>
    <Parameter name="p2"/></ParameterList>
  <CovariateList><Predictor name="f0"/><Predictor name="f1"/>
  </CovariateList>
  <PPMatrix>
    <PPCell value="1" predictorName="f0" parameterName="p1"/>
    <PPCell value="2" predictorName="f1" parameterName="p2"/>
  </PPMatrix>
  <ParamMatrix>
    <PCell parameterName="p0" beta="-0.3"/>
    <PCell parameterName="p1" beta="1.2"/>
    <PCell parameterName="p2" beta="-0.4"/>
  </ParamMatrix></GeneralRegressionModel></PMML>"""

NAIVE_BAYES = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="pos"/><Value value="neg"/></DataField>
  </DataDictionary>
  <NaiveBayesModel functionName="classification" threshold="0.001">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <BayesInputs>
    <BayesInput fieldName="f0"><TargetValueStats>
      <TargetValueStat value="pos"><GaussianDistribution mean="1.0"
        variance="1.0"/></TargetValueStat>
      <TargetValueStat value="neg"><GaussianDistribution mean="-1.0"
        variance="1.5"/></TargetValueStat>
    </TargetValueStats></BayesInput>
    <BayesInput fieldName="f1"><TargetValueStats>
      <TargetValueStat value="pos"><GaussianDistribution mean="0.0"
        variance="2.0"/></TargetValueStat>
      <TargetValueStat value="neg"><GaussianDistribution mean="0.5"
        variance="1.0"/></TargetValueStat>
    </TargetValueStats></BayesInput>
  </BayesInputs>
  <BayesOutput fieldName="cls"><TargetValueCounts>
    <TargetValueCount value="pos" count="60"/>
    <TargetValueCount value="neg" count="40"/>
  </TargetValueCounts></BayesOutput></NaiveBayesModel></PMML>"""

SVM = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="in"/><Value value="out"/></DataField>
  </DataDictionary>
  <SupportVectorMachineModel functionName="classification">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <RadialBasisKernelType gamma="0.8"/>
  <VectorDictionary numberOfVectors="2">
    <VectorFields numberOfFields="2">
      <FieldRef field="f0"/><FieldRef field="f1"/></VectorFields>
    <VectorInstance id="v1"><Array n="2" type="real">0 0</Array>
    </VectorInstance>
    <VectorInstance id="v2"><Array n="2" type="real">2 2</Array>
    </VectorInstance>
  </VectorDictionary>
  <SupportVectorMachine targetCategory="in" alternateTargetCategory="out">
    <SupportVectors numberOfSupportVectors="2">
      <SupportVector vectorId="v1"/><SupportVector vectorId="v2"/>
    </SupportVectors>
    <Coefficients absoluteValue="0.2">
      <Coefficient value="-1.0"/><Coefficient value="1.0"/>
    </Coefficients>
  </SupportVectorMachine>
  </SupportVectorMachineModel></PMML>"""

KNN = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="a"/><Value value="b"/></DataField>
  </DataDictionary>
  <NearestNeighborModel functionName="classification"
      numberOfNeighbors="3">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <ComparisonMeasure kind="distance"><euclidean/></ComparisonMeasure>
  <KNNInputs><KNNInput field="f0"/><KNNInput field="f1"/></KNNInputs>
  <TrainingInstances>
    <InstanceFields>
      <InstanceField field="f0" column="f0"/>
      <InstanceField field="f1" column="f1"/>
      <InstanceField field="cls" column="cls"/>
    </InstanceFields>
    <InlineTable>
      <row><f0>0</f0><f1>0</f1><cls>a</cls></row>
      <row><f0>0.5</f0><f1>0.5</f1><cls>a</cls></row>
      <row><f0>2</f0><f1>2</f1><cls>b</cls></row>
      <row><f0>2.5</f0><f1>1.5</f1><cls>b</cls></row>
      <row><f0>-1</f0><f1>2</f1><cls>b</cls></row>
    </InlineTable>
  </TrainingInstances></NearestNeighborModel></PMML>"""

IFOREST = """<PMML version="4.4"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="s" optype="continuous" dataType="double"/>
  </DataDictionary>
  <AnomalyDetectionModel functionName="regression"
      algorithmType="iforest" sampleDataSize="128">
  <MiningSchema><MiningField name="s" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <MiningModel functionName="regression">
    <MiningSchema><MiningField name="s" usageType="target"/>
      <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
    <Segmentation multipleModelMethod="average">
      <Segment><True/><TreeModel functionName="regression">
        <MiningSchema><MiningField name="s" usageType="target"/>
          <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
        <Node id="0"><True/>
          <Node id="1" score="2"><SimplePredicate field="f0"
            operator="greaterThan" value="2"/></Node>
          <Node id="2" score="7"><True/></Node>
        </Node></TreeModel></Segment>
      <Segment><True/><TreeModel functionName="regression">
        <MiningSchema><MiningField name="s" usageType="target"/>
          <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
        <Node id="0"><True/>
          <Node id="1" score="3"><SimplePredicate field="f1"
            operator="lessThan" value="-2"/></Node>
          <Node id="2" score="6"><True/></Node>
        </Node></TreeModel></Segment>
    </Segmentation></MiningModel>
  </AnomalyDetectionModel></PMML>"""


GP = """<PMML version="4.3"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  <DataField name="f1" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <GaussianProcessModel functionName="regression">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="f0"/><MiningField name="f1"/></MiningSchema>
  <RadialBasisKernel gamma="1.0" noiseVariance="0.1" lambda="1.0"/>
  <TrainingInstances recordCount="3">
    <InstanceFields>
      <InstanceField field="f0" column="f0"/>
      <InstanceField field="f1" column="f1"/>
      <InstanceField field="y" column="y"/>
    </InstanceFields>
    <InlineTable>
      <row><f0>0</f0><f1>0</f1><y>1.0</y></row>
      <row><f0>1</f0><f1>1</f1><y>-0.5</y></row>
      <row><f0>-1</f0><f1>0.5</f1><y>2.0</y></row>
    </InlineTable>
  </TrainingInstances></GaussianProcessModel></PMML>"""

BASELINE_Z = """<PMML version="4.2"><DataDictionary>
  <DataField name="f0" optype="continuous" dataType="double"/>
  </DataDictionary>
  <BaselineModel functionName="regression">
  <MiningSchema><MiningField name="f0"/></MiningSchema>
  <TestDistributions field="f0" testStatistic="zValue">
    <Baseline><GaussianDistribution mean="0.5" variance="1.44"/></Baseline>
  </TestDistributions></BaselineModel></PMML>"""

ASSOC = """<PMML version="4.2"><DataDictionary>
  <DataField name="beer" optype="continuous" dataType="double"/>
  <DataField name="chips" optype="continuous" dataType="double"/>
  <DataField name="wine" optype="continuous" dataType="double"/>
  <DataField name="bread" optype="continuous" dataType="double"/>
  </DataDictionary>
  <AssociationModel functionName="associationRules"
      numberOfTransactions="1000" numberOfItems="4"
      minimumSupport="0.1" minimumConfidence="0.5"
      numberOfItemsets="4" numberOfRules="2">
  <MiningSchema>
    <MiningField name="beer"/><MiningField name="chips"/>
    <MiningField name="wine"/><MiningField name="bread"/>
  </MiningSchema>
  <Item id="1" value="beer"/><Item id="2" value="chips"/>
  <Item id="3" value="wine"/><Item id="4" value="bread"/>
  <Itemset id="s1"><ItemRef itemRef="1"/></Itemset>
  <Itemset id="s2"><ItemRef itemRef="2"/></Itemset>
  <Itemset id="s3"><ItemRef itemRef="3"/></Itemset>
  <Itemset id="s4"><ItemRef itemRef="4"/></Itemset>
  <AssociationRule id="r1" support="0.4" confidence="0.7"
      antecedent="s1" consequent="s2"/>
  <AssociationRule id="r2" support="0.3" confidence="0.8"
      antecedent="s3" consequent="s4"/>
  </AssociationModel></PMML>"""


TIMESERIES = """<PMML version="4.3"><DataDictionary>
  <DataField name="h" optype="continuous" dataType="integer"/>
  <DataField name="sales" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TimeSeriesModel functionName="timeSeries" bestFit="ExponentialSmoothing">
  <MiningSchema><MiningField name="sales" usageType="target"/>
    <MiningField name="h"/></MiningSchema>
  <ExponentialSmoothing>
    <Level alpha="0.3" smoothedValue="120.5"/>
    <Trend_ExpoSmooth trend="damped_additive" gamma="0.1" smoothedValue="2.5"
        phi="0.85"/>
    <Seasonality_ExpoSmooth type="multiplicative" period="4" gamma="0.2">
      <Array n="4" type="real">1.1 0.9 1.05 0.95</Array>
    </Seasonality_ExpoSmooth>
  </ExponentialSmoothing></TimeSeriesModel></PMML>"""

# seasonal ARIMA(1,1,1)(0,1,0)_4 with drift over a short quarterly series
ARIMA = """<PMML version="4.4"><DataDictionary>
  <DataField name="h" optype="continuous" dataType="integer"/>
  <DataField name="demand" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TimeSeriesModel functionName="timeSeries" bestFit="ARIMA">
  <MiningSchema><MiningField name="demand" usageType="target"/>
    <MiningField name="h"/></MiningSchema>
  <TimeSeries usage="original">
    <TimeValue index="1" value="52.1"/><TimeValue index="2" value="47.3"/>
    <TimeValue index="3" value="55.8"/><TimeValue index="4" value="60.2"/>
    <TimeValue index="5" value="54.6"/><TimeValue index="6" value="49.9"/>
    <TimeValue index="7" value="58.4"/><TimeValue index="8" value="63.0"/>
    <TimeValue index="9" value="57.2"/><TimeValue index="10" value="52.4"/>
    <TimeValue index="11" value="61.1"/><TimeValue index="12" value="65.7"/>
  </TimeSeries>
  <ARIMA constantTerm="0.1" predictionMethod="conditionalLeastSquares">
    <NonseasonalComponent p="1" d="1" q="1">
      <AR><Array type="real" n="1">0.4</Array></AR>
      <MA>
        <MACoefficients><Array type="real" n="1">0.3</Array>
        </MACoefficients>
        <Residuals><Array type="real" n="1">0.25</Array></Residuals>
      </MA>
    </NonseasonalComponent>
    <SeasonalComponent P="0" D="1" Q="0" period="4"/>
  </ARIMA></TimeSeriesModel></PMML>"""

BAYESNET = """<PMML version="4.3"><DataDictionary>
  <DataField name="rain" optype="categorical" dataType="string">
    <Value value="yes"/><Value value="no"/></DataField>
  <DataField name="sprinkler" optype="categorical" dataType="string">
    <Value value="on"/><Value value="off"/></DataField>
  <DataField name="grass" optype="categorical" dataType="string">
    <Value value="wet"/><Value value="dry"/></DataField>
  </DataDictionary>
  <BayesianNetworkModel functionName="classification">
  <MiningSchema><MiningField name="rain" usageType="target"/>
    <MiningField name="sprinkler"/><MiningField name="grass"/></MiningSchema>
  <BayesianNetworkNodes>
    <DiscreteNode name="rain">
      <ValueProbability value="yes" probability="0.2"/>
      <ValueProbability value="no" probability="0.8"/>
    </DiscreteNode>
    <DiscreteNode name="sprinkler">
      <DiscreteConditionalProbability>
        <ParentValue parent="rain" value="yes"/>
        <ValueProbability value="on" probability="0.01"/>
        <ValueProbability value="off" probability="0.99"/>
      </DiscreteConditionalProbability>
      <DiscreteConditionalProbability>
        <ParentValue parent="rain" value="no"/>
        <ValueProbability value="on" probability="0.4"/>
        <ValueProbability value="off" probability="0.6"/>
      </DiscreteConditionalProbability>
    </DiscreteNode>
    <DiscreteNode name="grass">
      <DiscreteConditionalProbability>
        <ParentValue parent="sprinkler" value="on"/>
        <ParentValue parent="rain" value="yes"/>
        <ValueProbability value="wet" probability="0.99"/>
        <ValueProbability value="dry" probability="0.01"/>
      </DiscreteConditionalProbability>
      <DiscreteConditionalProbability>
        <ParentValue parent="sprinkler" value="on"/>
        <ParentValue parent="rain" value="no"/>
        <ValueProbability value="wet" probability="0.9"/>
        <ValueProbability value="dry" probability="0.1"/>
      </DiscreteConditionalProbability>
      <DiscreteConditionalProbability>
        <ParentValue parent="sprinkler" value="off"/>
        <ParentValue parent="rain" value="yes"/>
        <ValueProbability value="wet" probability="0.8"/>
        <ValueProbability value="dry" probability="0.2"/>
      </DiscreteConditionalProbability>
      <DiscreteConditionalProbability>
        <ParentValue parent="sprinkler" value="off"/>
        <ParentValue parent="rain" value="no"/>
        <ValueProbability value="wet" probability="0.0"/>
        <ValueProbability value="dry" probability="1.0"/>
      </DiscreteConditionalProbability>
    </DiscreteNode>
  </BayesianNetworkNodes></BayesianNetworkModel></PMML>"""

TEXTMODEL = """<PMML version="4.2"><DataDictionary>
  <DataField name="ball" optype="continuous" dataType="double"/>
  <DataField name="goal" optype="continuous" dataType="double"/>
  <DataField name="oven" optype="continuous" dataType="double"/>
  <DataField name="salt" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TextModel functionName="classification" numberOfTerms="4"
      numberOfDocuments="2">
  <MiningSchema>
    <MiningField name="ball"/><MiningField name="goal"/>
    <MiningField name="oven"/><MiningField name="salt"/>
  </MiningSchema>
  <TextDictionary><Array n="4" type="string">ball goal oven salt</Array>
  </TextDictionary>
  <TextCorpus><TextDocument id="sports"/><TextDocument id="cooking"/>
  </TextCorpus>
  <DocumentTermMatrix><Matrix>
    <Array n="4" type="real">5 3 0 0</Array>
    <Array n="4" type="real">0 0 4 6</Array>
  </Matrix></DocumentTermMatrix>
  <TextModelNormalization localTermWeights="logarithmic"
      globalTermWeights="none" documentNormalization="cosine"/>
  <TextModelSimilarity similarityType="cosine"/>
  </TextModel></PMML>"""


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-zoo-")
    rng = np.random.default_rng(7)

    docs = [
        ("RegressionModel (Iris LR)", gen_iris_lr(workdir), 4),
        ("TreeModel ensemble (GBM)",
         gen_gbm(workdir, n_trees=30, depth=4, n_features=6), 6),
        ("NeuralNetwork (MLP)",
         gen_mlp(workdir, n_inputs=16, hidden=(16,), n_classes=3), 16),
        ("ClusteringModel (KMeans)",
         gen_kmeans(workdir, k=3, n_features=4), 4),
        ("MiningModel modelChain (stacked)",
         gen_stacked(workdir, n_features=8, n_trees=10), 8),
    ]
    inline = [
        ("Scorecard (+reason codes)", SCORECARD, 2),
        ("RuleSetModel", RULESET, 2),
        ("GeneralRegressionModel (GLM)", GLM, 2),
        ("NaiveBayesModel", NAIVE_BAYES, 2),
        ("SupportVectorMachineModel", SVM, 2),
        ("NearestNeighborModel (KNN)", KNN, 2),
        ("AnomalyDetectionModel (iforest)", IFOREST, 2),
        ("GaussianProcessModel (RBF)", GP, 2),
        ("BaselineModel (zValue)", BASELINE_Z, 1),
        ("AssociationModel (baskets)", ASSOC, 4),
        ("TimeSeriesModel (Holt-Winters)", TIMESERIES, 1),
        ("TimeSeriesModel (seasonal ARIMA)", ARIMA, 1),
        ("BayesianNetworkModel (sprinkler)", BAYESNET, 2),
        ("TextModel (tf-idf cosine)", TEXTMODEL, 4),
    ]
    for i, (name, xml, arity) in enumerate(inline):
        path = str(pathlib.Path(workdir, f"zoo_{i}.pmml"))
        pathlib.Path(path).write_text(xml)
        docs.append((name, path, arity))

    print(f"{'family':38s} {'records':>7s}  sample result")
    for name, path, arity in docs:
        env = StreamEnvironment(
            RuntimeConfig(batch=BatchConfig(size=32, deadline_us=2000)),
            device=device,
        )
        if "Bayesian" in name:
            # categorical inputs ride the dense path as value CODES
            vectors = rng.integers(0, 2, size=(64, arity)).astype(
                np.float32
            ).tolist()
        else:
            vectors = rng.normal(0.5, 1.2, size=(64, arity)).astype(
                np.float32
            ).tolist()
        sink = env.from_collection(vectors).evaluate(
            ModelReader(path)
        ).collect()
        env.execute(timeout=120.0)
        p = next((x for x in sink.items if not x.is_empty), None)
        if p is None:
            desc = "all lanes empty?!"
        elif p.target is not None and p.target.label is not None:
            desc = f"label={p.target.label}"
            if p.outputs:
                desc += f" outputs={p.outputs}"
        else:
            desc = f"value={p.score.value:.4f}"
            if p.outputs:
                desc += f" outputs={p.outputs}"
        print(f"{name:38s} {len(sink.items):7d}  {desc}")


if __name__ == "__main__":
    main()
