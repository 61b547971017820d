"""PyTorch models of the ported architectures (dense GQA decoders)."""
from repro_torch.models.zoo import Model, params_from_jax

__all__ = ["Model", "params_from_jax"]
