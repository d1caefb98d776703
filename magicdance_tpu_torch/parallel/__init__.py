from magicdance_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    zero1_sharding,
)
