"""The check that no run loads JAX or the JAX package: each module's
top-level name (the part before the first dot) compared whole, so the
port, ``repro_torch``, is not taken for the JAX package, ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
