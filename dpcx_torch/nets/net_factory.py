"""Network registry: string -> module constructor (port of
``dpcx/nets/net_factory.py``)."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_network(name: str) -> Callable:
    def deco(ctor: Callable) -> Callable:
        _REGISTRY[name] = ctor
        return ctor

    return deco


def get_network(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown network '{name}'. Registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def _register_defaults() -> None:
    from dpcx_torch.nets.img_encoder import ImageEncoder
    from dpcx_torch.nets.pc_decoder import PointCloudDecoder
    from dpcx_torch.nets.pose import PoseHead

    _REGISTRY.setdefault("img_encoder", ImageEncoder)
    _REGISTRY.setdefault("pc_decoder", PointCloudDecoder)
    _REGISTRY.setdefault("pose_head", PoseHead)


_register_defaults()
