"""Small shared utilities (reference: utils_d3roma/utils.py:466-486).

Port of `d3roma_tpu/utils/misc.py`, kept for the same API: nothing in the
package calls these; they serve scripts and notebooks built on it."""

from __future__ import annotations

import json
import random
from collections.abc import MutableMapping


def seed_everything(seed: int) -> None:
    """Seed the host-side RNGs (`random`, numpy). The port's device noise
    comes from explicit `torch.Generator`s, so unlike the reference no
    global torch RNG is seeded."""
    import numpy as np

    random.seed(seed)
    np.random.seed(seed)


def flatten(dictionary: dict, parent_key: str = "", separator: str = "_") -> dict:
    """Flatten nested dicts for scalar logging (reference: utils.py:472-486);
    a value with `.item()` (a 0-d tensor or numpy scalar) becomes its
    Python number."""
    items = []
    for key, value in dictionary.items():
        new_key = parent_key + separator + key if parent_key else key
        if isinstance(value, MutableMapping):
            items.extend(flatten(value, new_key, separator=separator).items())
        else:
            if callable(getattr(value, "item", None)):
                value = value.item()
            items.append((new_key, value))
    return dict(items)


def pretty_json(d: dict) -> str:
    return json.dumps(d, indent=2, default=float)
