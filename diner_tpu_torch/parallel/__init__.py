"""Multi-process training over a ('data', 'rays') mesh of ranks: the port
of ``diner_tpu/parallel/``, with the names it exports where they mean
something in PyTorch (``constrain_rays`` is ``ray_slice``,
``replicate_pytree`` is ``replicate``; there is no global array to build).
"""

from diner_tpu_torch.parallel.distributed import (initialize,
                                                  is_multiprocess, shutdown)
from diner_tpu_torch.parallel.sharding import (DATA_AXIS, RAY_AXIS, Mesh,
                                               make_mesh, mesh_shape,
                                               ray_slice, replicate,
                                               shard_batch)
from diner_tpu_torch.parallel.train import (make_parallel_eval_step,
                                            make_parallel_train_step)

__all__ = [
    "DATA_AXIS",
    "RAY_AXIS",
    "Mesh",
    "initialize",
    "is_multiprocess",
    "make_mesh",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "mesh_shape",
    "ray_slice",
    "replicate",
    "shard_batch",
    "shutdown",
]
