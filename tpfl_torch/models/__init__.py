"""The port's model zoo."""

from tpfl_torch.models.zoo import (
    CNN,
    MLP,
    BatchNorm,
    ResidualBlock,
    ResNet18,
    TransformerBlock,
    TransformerLM,
    apply,
    create_model,
    init_params,
    init_state,
)

__all__ = ["BatchNorm", "CNN", "MLP", "ResNet18", "ResidualBlock", "TransformerBlock",
           "TransformerLM", "apply", "create_model", "init_params", "init_state"]
