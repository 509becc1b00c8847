"""Parallelism of the port: one process per device.

Counterpart of `news_image_caption_tpu/parallel/`. A JAX process drives
all its local devices; a process of the port drives one device,
`cuda:LOCAL_RANK` on the card or the CPU under `--platform cpu`, and
the processes of a run join one `torch.distributed` process group (NCCL
on the card, gloo on the CPU; `distributed.initialize`). A JAX mesh over
devices becomes a `DeviceMesh` over ranks with the same axis names
(`data`, `model`, `context`, `pipe`) in the same row-major layout, so
rank r holds the slice JAX's device r holds (`mesh.make_mesh`). Where
JAX partitions global arrays, each rank here holds its own slice and
the collectives are explicit:

- `data`: each rank trains on its rows of the global batch
  (`distributed.place_local`); the loss is the global batch's
  (`collectives.global_sums`) and the fp32 gradients are all-reduced
  (`training/train_step.py`); dropout draws the global batch's masks
  and keeps the rank's rows (`collectives.global_rows`);
- `context`: ring attention over sequence slices (`ring`, `sequence`);
- `pipe`: the GPipe schedule over layer stages (`pipe`);
- `model`: tensor parallelism under the reference's partition rules
  (`partition`): `shard_params` keeps each rank's slice of the
  attentions' heads, the FFN's columns and rows and the adaptive band
  tables' rows, and the modules run their split forms with explicit
  collectives (`collectives.copy_in`, `reduce_out`, `vocab_gather`),
  in training and in every decode engine; `gather_params` puts whole
  tensors back for a checkpoint. A dim the axis does not divide raises,
  as in the reference.
"""

from news_image_caption_tpu_torch.parallel.distributed import (
    initialize, place_local, shard_iterator)
from news_image_caption_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from news_image_caption_tpu_torch.parallel.partition import (gather_params,
                                                             shard_params,
                                                             spec_for_name)
from news_image_caption_tpu_torch.parallel.pipe import (pipeline_apply,
                                                        stack_layers)
from news_image_caption_tpu_torch.parallel.ring import ring_attention

__all__ = [
    "ring_attention",
    "pipeline_apply",
    "stack_layers",
    "make_mesh",
    "MeshConfig",
    "initialize",
    "shard_iterator",
    "place_local",
    "shard_params",
    "spec_for_name",
    "gather_params",
]
