"""Port of `d3roma_tpu/synthetic/isaac/assets.py` (numpy, the same draws).

DREDS CAD-asset catalog scanning and per-scene model sampling.

Pure-python analog of the reference's `DredsRenderer.domain_randomize`
model selection (reference: isaacsim/dreds_renderer.py:380-540 +
`g_synset_name_scale_pairs`): walk the CAD root for per-class instance
USDs, sample n instances with per-class metric scales and DREDS material
classes. The backend only turns the returned dicts into prims
(std_object.py:118-143); everything here is unit-testable on a fake tree.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from d3roma_tpu_torch.synthetic.isaac.materials import assign_materials

# per-class metric rescale, DREDS protocol (dreds_renderer.py's
# g_synset_name_scale_pairs — CAD models are normalized units)
CLASS_SCALES: Dict[str, float] = {
    "aeroplane": 0.25, "bottle": 0.25, "bowl": 0.25, "camera": 0.2,
    "can": 0.18, "car": 0.25, "cup": 0.2, "mug": 0.2,
}
DEFAULT_SCALE = 0.22


def scan_cad_catalog(cad_root: str) -> List[Dict]:
    """List CAD instances: {class_name, instance_name, instance_path}.

    Layout (as consumed by the reference's renderer): either
    cad_root/<class>/<instance>/*.usd[a|c] or cad_root/<class>/*.usd.
    """
    catalog = []
    if not cad_root or not os.path.isdir(cad_root):
        return catalog
    for cls in sorted(os.listdir(cad_root)):
        cls_dir = os.path.join(cad_root, cls)
        if not os.path.isdir(cls_dir):
            continue
        for dirpath, _, files in os.walk(cls_dir):
            for f in sorted(files):
                if f.endswith((".usd", ".usda", ".usdc")):
                    inst = os.path.splitext(f)[0]
                    catalog.append({
                        "class_name": cls,
                        "instance_name": f"{cls}_{inst}",
                        "instance_path": os.path.join(dirpath, f),
                    })
    return catalog


def sample_cad_models(
    rng: np.random.Generator,
    cad_root: str,
    n: int,
    material_probs: Sequence[float] = (0.4, 0.3, 0.3),
    catalog: Optional[List[Dict]] = None,
) -> List[Dict]:
    """Sample n models with instance ids, scales and material classes
    (the reference's select_model_list shape, dreds_renderer.py:380-540)."""
    catalog = catalog if catalog is not None else scan_cad_catalog(cad_root)
    if not catalog:
        return []
    idx = rng.integers(0, len(catalog), size=n)
    classes = assign_materials(rng, n, material_probs)
    out = []
    for i, (ci, mat) in enumerate(zip(idx, classes)):
        entry = dict(catalog[int(ci)])
        entry["instance_id"] = i
        # sampling is WITH replacement: a duplicated catalog entry must
        # still get a unique instance_name (it keys _spawned bookkeeping
        # and the RigidPrim name — collisions corrupted the
        # saved-original-material restore in the GT pass)
        entry["instance_name"] = f"{entry['instance_name']}_{i}"
        entry["scale"] = CLASS_SCALES.get(entry["class_name"], DEFAULT_SCALE)
        entry["material_type"] = mat
        out.append(entry)
    return out
