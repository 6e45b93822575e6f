"""The port's model zoo."""

from tpfl_torch.models.zoo import CNN, TransformerBlock, TransformerLM, create_model, init_params

__all__ = ["CNN", "TransformerBlock", "TransformerLM", "create_model", "init_params"]
