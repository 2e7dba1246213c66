"""Data and tensor parallelism over ``torch.distributed`` (the JAX package's
``parallel/``): meshes and sharding rules (``mesh.py``), the collectives
(``collectives.py``), a launcher of ranks (``launch.py``) and the multi-rank
dry run (``dryrun.py``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    RankShard,
    batch_sharding,
    broadcast_module,
    data_extent,
    gather_state_dict,
    init_distributed,
    make_mesh,
    make_multislice_mesh,
    param_shardings,
    rank_shard,
    replicated,
    shard_for_inference,
    shard_model,
)
