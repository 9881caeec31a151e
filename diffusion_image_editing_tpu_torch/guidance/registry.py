"""Attribute-function registry: the port of `guidance/registry.py` for the
strategies ported so far."""

from __future__ import annotations

from typing import Any, Dict, Optional, Type, Union

from .attr_functions import AttrFunc, MultiColorAttrFunc, SingleColorAttrFunc


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
    registry = AttrFuncRegistry()
    registry.register(SingleColorAttrFunc)
    registry.register(MultiColorAttrFunc)
    return registry
