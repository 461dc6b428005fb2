"""Batched on-device preprocessing.

Port of `d3roma_tpu/data/preprocess.py` on torch tensors: the host does file
IO and the shape-defining crop and flip, and this does the numeric work
batched on the pipeline's device — depth -> disparity, the Normalizer,
RGB scaling to [-1, 1]. `preprocess_eval` is the counterpart of the JAX
train loop's `_preprocess_eval`: it moves a host batch to the device and
preprocesses it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from d3roma_tpu_torch.ops.normalizer import Normalizer


def device_preprocess(raw: Dict[str, torch.Tensor], normalizer: Normalizer,
                      space: str = "disp") -> Dict[str, torch.Tensor]:
    """raw batch (channel-last, float32):
      disp [B,H,W,1], valid [B,H,W,1], depth [B,H,W,1] (m),
      raw_depth [B,H,W,1] (m), rgb/left/right [B,H,W,3] in [0,255],
      fxb [B].

    Returns the reference's standard item dict fields
    (stereo_datasets.py:520-545), normalized and batched.
    """
    disp = raw["disp"]
    valid = raw["valid"]
    depth = raw["depth"]
    raw_depth = raw["raw_depth"]
    fxb = raw["fxb"].reshape(-1, 1, 1, 1)
    zero = torch.zeros((), dtype=raw_depth.dtype, device=raw_depth.device)

    if space == "disp":
        gt_data = disp
        normalized, low, up = normalizer.normalize(disp, valid > 0)
        sim_valid = (valid > 0) & (raw_depth > 0)
        sim_disp_unnorm = torch.where(sim_valid, fxb / torch.clamp(raw_depth, min=1e-8), zero)
        normalized_sim, _, _ = normalizer.normalize(sim_disp_unnorm, sim_valid, low, up)
    elif space == "depth":
        gt_data = depth
        normalized, _, _ = normalizer.normalize(depth, valid > 0)
        sim_valid = raw_depth > 0
        # the guidance/SSI alignment target in depth space IS the raw
        # depth (all-zeros here would make the guidance denormer mask
        # empty and silently pull predictions toward zero)
        sim_disp_unnorm = torch.where(sim_valid, raw_depth, zero)
        normalized_sim, _, _ = normalizer.normalize(raw_depth, sim_valid)
    else:
        raise NotImplementedError(space)

    def to_norm_rgb(x):
        return (x / 255.0 - 0.5) * 2.0

    out = {
        "raw_disp": gt_data,
        "normalized_disp": normalized,
        "sim_disp": normalized_sim,
        "sim_mask": sim_valid.to(torch.float32),
        "sim_disp_unnorm": sim_disp_unnorm,
        "normalized_rgb": to_norm_rgb(raw["rgb"]),
        "left_image": to_norm_rgb(raw["left"]),
        "right_image": to_norm_rgb(raw["right"]),
        "mask": valid.to(torch.float32),
        "depth": depth,
        "raw_depth": raw_depth,
        "fxb": raw["fxb"],
    }
    for k in ("K", "index", "sample_valid"):
        if k in raw:
            out[k] = raw[k]
    return out


def preprocess_eval(raw_batch: dict, config, normalizer: Normalizer,
                    device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays; lists of paths and device names are
    dropped) moved to `device` and preprocessed in the config's
    prediction space."""
    arrays = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in raw_batch.items()
              if not isinstance(v, (list, str))}
    return device_preprocess(arrays, normalizer, config.prediction_space)
