"""Context parallelism on ``torch.distributed``: the launch, the device
mesh, the collectives with their byte log, Ulysses and ring attention, and
the halo exchange of the spatially sharded VAE."""
