"""The port's model zoo."""

from tpfl_torch.models.zoo import CNN, create_model, init_params

__all__ = ["CNN", "create_model", "init_params"]
