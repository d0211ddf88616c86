"""Mesh parallelism: subjects over a data axis, the GP state over a latent
axis, on ``torch.distributed`` (port of ``hlax/parallel``)."""
