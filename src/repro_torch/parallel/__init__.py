from repro_torch.parallel.collectives import (all_gather, axis_index,
                                             axis_size, pmax, ppermute, psum,
                                             shard, vary)
from repro_torch.parallel.sharding import (P, PartitionSpec, batch_specs,
                                          cache_partition_specs, gather,
                                          named, opt_state_specs,
                                          param_partition_specs, place)

__all__ = ["P", "PartitionSpec", "all_gather", "axis_index", "axis_size",
           "batch_specs", "cache_partition_specs", "gather", "named",
           "opt_state_specs", "param_partition_specs", "place", "pmax",
           "ppermute", "psum", "shard", "vary"]
