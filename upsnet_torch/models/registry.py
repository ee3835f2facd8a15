"""Model registry keyed by the reference's ``config.symbol`` names
(``resnet_50_upsnet``, ``resnet_101_upsnet``)."""

from __future__ import annotations

_REGISTRY: dict = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, *args, **kwargs):
    if name not in _REGISTRY:
        import upsnet_torch.models.upsnet  # noqa: F401  (registers the symbols)
    if name not in _REGISTRY:
        raise KeyError(f"unknown model symbol {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)
