from tpu_vo_torch.parallel.mesh import make_mesh
from tpu_vo_torch.parallel.sharding import (
    run_batch_of_sequences,
    run_sequence_time_sharded,
)

__all__ = [
    "make_mesh",
    "run_batch_of_sequences",
    "run_sequence_time_sharded",
]
