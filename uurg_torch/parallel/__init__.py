"""Data parallel, FSDP and tensor parallel on ``torch.distributed`` (port
of ``uurg_tpu/parallel``; the pipeline and ring attention come with a
later slice)."""
from uurg_torch.parallel.dist import (initialize_distributed, rank,
                                      sync_global_devices, world_size)
from uurg_torch.parallel.mesh import (DIT_TP_RULES, SD_TP_RULES, TPRule,
                                      batch_split, fsdp_param_specs,
                                      fsdp_spec, make_mesh, parse_mesh_spec,
                                      place_model, replicate, shard_batch,
                                      shard_params_fsdp, shard_params_tp,
                                      split_batches, tp_param_specs)
