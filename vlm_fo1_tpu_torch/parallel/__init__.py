from vlm_fo1_tpu_torch.parallel.multihost import (  # noqa: F401
    create_hybrid_mesh,
    initialize_distributed,
)
from vlm_fo1_tpu_torch.parallel.sharding import (  # noqa: F401
    create_mesh,
    data_rows,
    param_specs,
    shard_model,
)
