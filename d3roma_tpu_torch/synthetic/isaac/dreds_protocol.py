"""Port of `d3roma_tpu/synthetic/isaac/dreds_protocol.py` (numpy, the same draws).

DREDS domain-randomization protocol: the distributions themselves.

The reference scatters these across dreds_renderer.py (class tables,
material-mode sampling, model selection at :458-540) and
replicate/std_object.py:25-110 + scene_replicator.py:283-362 (per-light-
type intensity tables and the per-tick on/off sequences), parameterized
by isaacsim/config/hssd.yaml. Here the protocol is one importable,
seedable module so it can be asserted in CI (the omni calls stay behind
backend.py) and shared with the procedural renderer.

Tables are DREDS-protocol data (value-for-value the published protocol's
constants), not code.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# --- class tables (reference: dreds_renderer.py:111-143) --------------- #

#: per-class uniform scale RANGES (dreds_renderer.py:111-118)
CLASS_SCALE_RANGES: Dict[str, tuple] = {
    "aeroplane": (0.25, 0.31),
    "bottle": (0.21, 0.27),
    "bowl": (0.15, 0.20),
    "camera": (0.17, 0.23),
    "can": (0.13, 0.17),
    "car": (0.21, 0.25),
    "mug": (0.13, 0.19),
    "other": (0.13, 0.22),
}

#: which material classes a semantic class can take
#: (dreds_renderer.py:134-136)
CLASS_MATERIAL_PAIRS: Dict[str, tuple] = {
    "specular": ("bottle", "bowl", "can", "mug", "aeroplane", "car",
                 "other"),
    "transparent": ("bottle", "bowl", "mug"),
    "diffuse": ("bottle", "bowl", "can", "mug", "camera", "aeroplane",
                "car", "other"),
}

#: classes guaranteed one transparent-capable instance per scene
#: (dreds_renderer.py:499-502)
TRANSPARENT_CLASSES = ("bottle", "bowl", "mug")


def dreds_material_type(rng: np.random.Generator, class_name: str) -> str:
    """The DREDS mixed-mode per-object material draw
    (dreds_renderer.py::generate_material_type): 1/4 of draws pick
    raw-or-diffuse (diffuse only for transparent-capable classes), the
    rest split 2:1 between transparent (falling through to specular /
    diffuse when the class cannot be transparent) and specular."""
    if rng.integers(0, 4) == 0:
        if rng.integers(0, 2) == 0:
            return "raw"
        if class_name in TRANSPARENT_CLASSES:
            return "diffuse"
        return "raw"
    flag = int(rng.integers(0, 3))
    if flag < 2:
        if class_name in TRANSPARENT_CLASSES:
            return "transparent"
        flag = 2
    if flag == 2:
        if class_name in CLASS_MATERIAL_PAIRS["specular"]:
            return "specular"
        return "diffuse"
    return "raw"


def dreds_select_models(rng: np.random.Generator,
                        catalog: Sequence[Dict]) -> List[Dict]:
    """The DREDS per-scene model-selection protocol
    (dreds_renderer.py:492-516): one instance from EACH
    transparent-capable class present, one candidate per remaining named
    class and up to 3 'other' distractors — then the named candidates are
    subsampled to 1-4 and the distractors to 1-3. Returns catalog entries
    with instance ids, protocol scales and material types."""
    by_class: Dict[str, list] = {}
    for e in catalog:
        by_class.setdefault(e["class_name"], []).append(e)

    def pick(entries, k):
        k = min(k, len(entries))
        idx = rng.choice(len(entries), size=k, replace=False)
        return [entries[int(i)] for i in idx]

    transparent, named, distractors = [], [], []
    for cls, entries in sorted(by_class.items()):
        if cls in TRANSPARENT_CLASSES:
            transparent += pick(entries, 1)
        elif cls == "other":
            distractors += pick(entries, 3)
        else:
            named += pick(entries, 1)
    if named:
        named = pick(named, int(rng.integers(1, 5)))
    if distractors:
        distractors = pick(distractors, int(rng.integers(1, 4)))

    out = []
    for i, entry in enumerate(transparent + named + distractors):
        e = dict(entry)
        e["instance_id"] = i
        e["instance_name"] = f"{e['instance_name']}_{i}"
        lo, hi = CLASS_SCALE_RANGES.get(e["class_name"],
                                        CLASS_SCALE_RANGES["other"])
        e["scale"] = float(rng.uniform(lo, hi))
        e["material_type"] = dreds_material_type(rng, e["class_name"])
        out.append(e)
    return out


def sample_placement(rng: np.random.Generator, anchor, instance_id: int):
    """Initial rigid-body pose for a spawned object before physics
    settling (std_object.py:129-134): xy scatter +-0.3 m around the
    surface anchor, stacked 5 cm per instance in z, random euler
    orientation in ([0, pi/2], [0, pi/2], [0, pi])."""
    pos = np.asarray(anchor, np.float64) + np.array([
        rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
        (instance_id + 1) * 0.05,
    ])
    euler = np.array([rng.uniform(0, np.pi / 2), rng.uniform(0, np.pi / 2),
                      rng.uniform(0, np.pi)])
    return pos, euler


# --- lighting tables (reference: isaacsim/config/hssd.yaml:82-112, ----- #
# sampled per scene in std_object.py:25-67, sequenced per tick in
# scene_replicator.py:319-326)

#: per-light-type DR tables: geometry ranges + on/off intensity ranges.
#: "on" lights the RGB tick; "off" (dim) lights the IR tick, where the
#: projector supplies the light.
LIGHT_TABLES: Dict[str, Dict] = {
    "Sphere": {
        "radius": (1.0, 1.0),
        "height": (2.5, 2.5),
        "intensity_on": (10000.0, 10000.0),
        "intensity_off": (500.0, 500.0),
        "treat_as_point": True,
    },
    "Disk": {
        "radius": (1.0, 1.0),
        "height": (1.5, 1.5),
        "intensity_on": (10000.0, 10000.0),
        "intensity_off": (200.0, 400.0),
        "treat_as_point": False,
    },
    "Rect": {
        "width": (100.0, 100.0),
        "height": (100.0, 100.0),
        "intensity_on": (50000.0, 50000.0),
        "intensity_off": (2000.0, 2000.0),
        "treat_as_point": False,
    },
}

#: distant (environment) light: constant intensity on the RGB tick, 10 on
#: the IR tick (scene_replicator.py:325-326)
DISTANT_LIGHT_INTENSITY = 0.0
DISTANT_LIGHT_IR_INTENSITY = 10.0


def sample_lighting(rng: np.random.Generator,
                    light_types: Sequence[str] = ("Sphere",)) -> Dict:
    """Per-scene lighting DR draw (std_object.py:25-55): pick a light
    type, then its geometry and on/off intensities from that type's
    table. The light sits `height` above the surface anchor."""
    lt = light_types[int(rng.integers(0, len(light_types)))]
    tab = LIGHT_TABLES[lt]
    out = {"type": lt, "treat_as_point": bool(tab.get("treat_as_point"))}
    for k in ("radius", "height", "width"):
        if k in tab:
            out[k] = float(rng.uniform(*tab[k]))
    out["intensity"] = [float(rng.uniform(*tab["intensity_on"])),
                        float(rng.uniform(*tab["intensity_off"]))]
    out["env_intensity"] = [DISTANT_LIGHT_INTENSITY,
                            DISTANT_LIGHT_IR_INTENSITY]
    return out


def tick_intensities(lighting: Dict, n_steps: int):
    """The per-tick (scene, env) intensity sequences for n_steps
    rgb+ir frame pairs (scene_replicator.py:319-326): [on, off] and
    [env, 10] alternating."""
    on, off = lighting["intensity"]
    env_on, env_off = lighting["env_intensity"]
    return ([on, off] * n_steps, [env_on, env_off] * n_steps)
