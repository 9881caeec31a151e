"""Attribute-function registry: the port of `guidance/registry.py`."""

from __future__ import annotations

from typing import Any, Dict, Optional, Type, Union

from .attr_functions import (
    AnyGANAttrFunc,
    AttrFunc,
    ClassifierAttrFunc,
    MultiColorAttrFunc,
    NetAttrFunc,
    SingleColorAttrFunc,
)


class AttrFuncRegistry:
    """Name -> strategy class-or-instance registry with a parameterising get()."""

    def __init__(self) -> None:
        self._registry: Dict[str, Union[Type[AttrFunc], AttrFunc]] = {}

    def register(self, strategy: Union[Type[AttrFunc], AttrFunc]) -> None:
        name = strategy.__name__ if isinstance(strategy, type) else strategy.name
        self._registry[name] = strategy

    def get(self, name: str, params: Optional[Dict[str, Any]] = None) -> AttrFunc:
        entry = self._registry.get(name)
        if entry is None:
            raise ValueError(f"No strategy registered with name: {name}")
        if isinstance(entry, type):
            return entry(**params) if params else entry()
        return entry

    def get_attribute_functions(self) -> list:
        return list(self._registry.keys())


def create_attr_func_registry() -> AttrFuncRegistry:
    """The four strategies, the classifier's also under the reference's
    `AnyGANAttrFunc` name."""
    registry = AttrFuncRegistry()
    registry.register(SingleColorAttrFunc)
    registry.register(MultiColorAttrFunc)
    registry.register(NetAttrFunc)
    registry.register(ClassifierAttrFunc)
    registry._registry["AnyGANAttrFunc"] = AnyGANAttrFunc
    return registry
