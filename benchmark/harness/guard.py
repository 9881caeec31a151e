"""What the benchmark may not load: JAX, its libraries, and the JAX package
that the port was made from. Names are compared whole, by the part before
the first dot, since the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "diffusion_image_editing_tpu"})


def forbidden(names: Iterable[str], banned: Iterable[str] = FORBIDDEN) -> List[str]:
    banned = frozenset(banned)
    return sorted({n.split(".", 1)[0] for n in names} & banned)


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
