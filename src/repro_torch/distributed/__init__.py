"""Data-parallel training and fault tolerance of the port (mirrors
``repro.distributed``), on ``torch.distributed``: one process per rank
(``group.py``), a ``Mesh`` of those ranks in each (``sharding.py``)."""
from .sharding import (DEFAULT_RULES, Mesh, NamedSharding, P, PartitionSpec,
                       RankDevice, current_mesh, data_shards, make_rules,
                       named_sharding, projection_shardings, rank_devices,
                       set_context, sharding_context, spec_for)
from .data_parallel import (make_data_parallel_projection_epoch,
                            make_data_parallel_supervised_epoch,
                            make_data_parallel_supervised_step,
                            make_data_parallel_unsupervised_step)
from .fault import (StepTimer, WorkerLost, describe_failure_domains,
                    elastic_mesh, fit_mesh_shape, order_devices_host_major)
from .group import DataAxis, RankFailed, RankGroup, run_group

__all__ = [
    "DEFAULT_RULES", "Mesh", "NamedSharding", "P", "PartitionSpec",
    "RankDevice", "current_mesh", "data_shards", "make_rules",
    "named_sharding", "projection_shardings", "rank_devices", "set_context",
    "sharding_context", "spec_for",
    "make_data_parallel_projection_epoch",
    "make_data_parallel_supervised_epoch",
    "make_data_parallel_supervised_step",
    "make_data_parallel_unsupervised_step",
    "StepTimer", "WorkerLost", "describe_failure_domains", "elastic_mesh",
    "fit_mesh_shape", "order_devices_host_major",
    "DataAxis", "RankFailed", "RankGroup", "run_group",
]
