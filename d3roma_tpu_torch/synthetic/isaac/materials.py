"""Port of `d3roma_tpu/synthetic/isaac/materials.py` (numpy, the same draws).

DREDS material-randomization protocol as pure data.

Each object gets a material class (diffuse / specular / transparent) drawn
from configured probabilities, then a concrete OmniPBR/OmniGlass parameter
dict sampled from the DREDS domain-randomization ranges. The specs are
plain dicts so the protocol is unit-testable; binding them to USD prims is
the backend's job (reference: isaacsim/replicate/std_object.py:120-213,
isaacsim/dreds_renderer.py:380-540).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MATERIAL_CLASSES = ("diffuse", "specular", "transparent")

# DREDS-style randomization ranges
SPECULAR_RANGES = {
    "metallic_constant": (0.7, 1.0),
    "reflection_roughness_constant": (0.0, 0.3),
}
TRANSPARENT_RANGES = {
    "glass_ior": (1.4, 1.55),
    "thin_walled": (0, 1),  # bernoulli
}
DIFFUSE_RANGES = {
    "reflection_roughness_constant": (0.4, 0.9),
}


def assign_materials(
    rng: np.random.Generator, n_objects: int, probs: Sequence[float]
) -> List[str]:
    """Per-object material class per the DREDS protocol; `probs` orders as
    (diffuse, specular, transparent)."""
    p = np.asarray(probs, np.float64)
    p = p / p.sum()
    return [MATERIAL_CLASSES[rng.choice(3, p=p)] for _ in range(n_objects)]


def sample_material_spec(rng: np.random.Generator, mclass: str) -> Dict:
    """Concrete shader-input dict for one object's randomized material.
    Keys mirror the OmniPBR/OmniGlass inputs the reference sets
    (std_object.py:160-213: diffuse_color_constant,
    reflection_roughness_constant, metallic_constant, glass params)."""
    if mclass == "specular":
        return {
            "class": "specular",
            "mdl": "OmniPBR.mdl",
            "diffuse_color_constant": tuple(rng.uniform(0.2, 0.9, 3).round(4)),
            "metallic_constant": float(rng.uniform(*SPECULAR_RANGES["metallic_constant"])),
            "reflection_roughness_constant": float(
                rng.uniform(*SPECULAR_RANGES["reflection_roughness_constant"])
            ),
        }
    if mclass == "transparent":
        return {
            "class": "transparent",
            "mdl": "OmniGlass.mdl",
            "glass_ior": float(rng.uniform(*TRANSPARENT_RANGES["glass_ior"])),
            "thin_walled": bool(rng.integers(0, 2)),
            "depth_opaque": True,  # GT depth pass binds the opaque original
        }
    if mclass == "raw":
        # keep the asset's own material untouched (DREDS raw mode —
        # dreds_renderer.py::generate_material_type)
        return {"class": "raw"}
    if mclass == "diffuse":
        return {
            "class": "diffuse",
            "mdl": "OmniPBR.mdl",
            "diffuse_color_constant": tuple(rng.uniform(0.05, 0.95, 3).round(4)),
            "reflection_roughness_constant": float(
                rng.uniform(*DIFFUSE_RANGES["reflection_roughness_constant"])
            ),
        }
    raise ValueError(f"unknown material class {mclass!r}")


def sample_scene_materials(
    rng: np.random.Generator, n_objects: int, probs: Sequence[float]
) -> List[Dict]:
    """Class assignment + concrete spec for every object in a scene."""
    return [sample_material_spec(rng, c)
            for c in assign_materials(rng, n_objects, probs)]
