"""Multi-process rendering and training over torch.distributed (one rank is
one device): the counterpart of the JAX package's parallel/."""
