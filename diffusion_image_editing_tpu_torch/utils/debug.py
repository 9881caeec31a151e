"""Numerical guards: the port of the JAX package's `utils/debug.py`.

  * `checkify_nans(fn)`: wraps a function so that a non-finite value in any
    floating-point tensor of its output raises, naming where it is (the
    counterpart of `jax.experimental.checkify`'s float checks, on the
    outputs).
  * `assert_finite(tree)`: the same check over a nested structure.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree: Any, name: str = "value") -> None:
    """Raises FloatingPointError if a floating-point tensor, array or number
    of the nested dicts, lists and tuples `tree` holds a NaN or an infinity;
    other leaves are skipped. Waits for the device."""
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            bad = (leaf.is_floating_point() or leaf.is_complex()) and not bool(
                torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind in "fc" and not bool(np.isfinite(arr).all())
        if bad:
            raise FloatingPointError(f"non-finite values in {name} at {path or '<root>'}")


def checkify_nans(fn: Callable) -> Callable:
    """Returns fn' that runs `fn` and raises FloatingPointError when its
    output holds a non-finite value."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name=f"the output of {getattr(fn, '__name__', 'fn')}")
        return out

    return wrapper
