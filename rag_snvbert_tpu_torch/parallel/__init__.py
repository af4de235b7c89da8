"""Scale-out over ``torch.distributed``: the (data, index, model) mesh
(``mesh``), its collectives (``comm``), local worlds of ranks
(``launch``), multi-host input (``multihost``) and tensor parallelism
(``tp``).  Port of rag_snvbert_tpu/parallel/."""

from .mesh import (AXES, DATA_AXIS, INDEX_AXIS, MODEL_AXIS, axis_group,
                   axis_rank, axis_size, data_sharding, index_row_sharding,
                   init_distributed, is_writer, make_mesh, replicated,
                   shard_batch)
