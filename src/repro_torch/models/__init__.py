"""The port's model core: GECToR's encoder stack in PyTorch."""
from repro_torch.models.transformer import forward, init_params  # noqa: F401
