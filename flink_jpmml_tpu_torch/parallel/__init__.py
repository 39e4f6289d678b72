"""Device mesh, sharding, keyed partitioning (SURVEY.md section 8 step 4).

The port's ``parallel`` package re-exports what the JAX package's does:
the mesh (``mesh.py``), sharded models (``sharding.py``), the keyed
partitioner, the process group (``distributed.py``) and worker health
(``health.py``)."""

from flink_jpmml_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
)
from flink_jpmml_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardedModel,
    TpLinearScorer,
    dp_sharded,
    mp_gp,
    tp_linear,
)
from flink_jpmml_tpu_torch.parallel.partitioner import (  # noqa: F401
    HashPartitioner,
    rendezvous_pick,
    stable_hash,
    stable_hash_vec,
)
from flink_jpmml_tpu_torch.parallel.distributed import (  # noqa: F401
    global_batch,
    init_distributed,
)
from flink_jpmml_tpu_torch.parallel.health import (  # noqa: F401
    HealthCoordinator,
    HealthReporter,
)
