"""Data parallel, FSDP, tensor parallel, the DiT pipeline and ring
attention on ``torch.distributed`` (port of ``uurg_tpu/parallel``)."""
from uurg_torch.parallel.dist import (initialize_distributed, rank,
                                      sync_global_devices, world_size)
from uurg_torch.parallel.mesh import (DIT_TP_RULES, SD_TP_RULES, TPRule,
                                      batch_split, fsdp_param_specs,
                                      fsdp_spec, make_mesh, parse_mesh_spec,
                                      place_model, replicate, shard_batch,
                                      shard_params_fsdp, shard_params_pp,
                                      shard_params_tp, split_batches,
                                      tp_param_specs)
from uurg_torch.parallel.pipeline import (dit_apply_pipelined, dit_embed,
                                          dit_final, pipeline_blocks,
                                          stage_block_apply)
from uurg_torch.parallel.sequence import (active_sequence_parallel,
                                          ring_attention,
                                          ring_attention_loopback,
                                          sequence_parallel)
