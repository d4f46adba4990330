"""Data and spatial parallelism on the card (counterpart of
giga_tpu/parallel/): ``distributed`` wires one process per card into a
``torch.distributed`` group, ``mesh`` names the group's axes and moves
batches between the global host view and each rank's shard, ``dryrun``
drives every sharded program once across spawned ranks."""
