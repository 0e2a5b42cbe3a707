"""Data parallel and FSDP on ``torch.distributed`` (port of
``uurg_tpu/parallel``; tensor parallel, the pipeline and ring attention
come with later slices)."""
from uurg_torch.parallel.dist import (initialize_distributed, rank,
                                      sync_global_devices, world_size)
from uurg_torch.parallel.mesh import (batch_split, fsdp_param_specs,
                                      fsdp_spec, make_mesh, parse_mesh_spec,
                                      place_model, replicate, shard_batch,
                                      shard_params_fsdp, split_batches)
