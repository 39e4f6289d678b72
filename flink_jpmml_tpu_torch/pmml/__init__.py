"""PMML 4.x ingestion: XML parsing into the typed IR (copies of the JAX
package's ``pmml/parser.py`` and ``pmml/ir.py``)."""

from flink_jpmml_tpu_torch.pmml.parser import parse_pmml, parse_pmml_file  # noqa: F401
from flink_jpmml_tpu_torch.pmml.ir import PmmlDocument  # noqa: F401
