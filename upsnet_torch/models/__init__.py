from upsnet_torch.models.registry import get_model, register_model

__all__ = ["get_model", "register_model"]
