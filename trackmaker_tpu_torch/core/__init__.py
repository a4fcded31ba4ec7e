from trackmaker_tpu_torch.core.config import PhyConfig  # noqa: F401
