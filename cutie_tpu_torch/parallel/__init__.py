from cutie_tpu_torch.parallel.mesh import (Mesh, init_distributed, make_mesh,
                                           process_rank, shard_batch)
from cutie_tpu_torch.parallel.sharded_memory import (make_mem_mesh, shard_memory,
                                                     sharded_composite_readout,
                                                     sharded_topk_readout)

__all__ = ["Mesh", "init_distributed", "make_mesh", "process_rank", "shard_batch",
           "make_mem_mesh", "shard_memory", "sharded_composite_readout",
           "sharded_topk_readout"]
