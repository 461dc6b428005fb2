"""The port's point clouds (d3roma_tpu_torch/utils/pointcloud.py,
streaming/realsense.py) against the JAX package's, numpy on both sides, so
equal means bit-equal: back-projection, the transform, the voxel
downsampling, `rgbd_to_pointcloud`, `crop_workspace`, `merge_xyz_rgb`;
`write_ply` byte-equal (uint8, float and no colours, an empty cloud) and
read back by `read_ply`; and the evaluation loop's `task.write_pcd`:
`idx{i}_pred.ply` byte-equal to the JAX loop's, with a stand-in pipeline
whose output is its sim_disp condition in both packages (its predictions
are then bit-equal, as tests/test_torch_evaluate.py shows)."""

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.streaming import realsense as jax_rs
from d3roma_tpu.utils import pointcloud as jax_pc
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.pipelines import PipelineOutput
from d3roma_tpu_torch.streaming import realsense as rs
from d3roma_tpu_torch.utils import pointcloud as pc

K = np.array([[40.0, 0.0, 15.5], [0.0, 41.0, 11.5], [0.0, 0.0, 1.0]])
T = np.array([[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, -0.2], [0.0, 0.0, 1.0, 0.3],
              [0.0, 0.0, 0.0, 1.0]])


def _rgbd(seed, hw=(24, 32)):
    r = np.random.RandomState(seed)
    rgb = r.randint(0, 256, hw + (3,)).astype(np.uint8)
    depth = r.uniform(0.2, 1.5, hw).astype(np.float32)
    depth[r.rand(*hw) < 0.2] = 0.0
    return rgb, depth


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_backproject_transform_voxel_match_jax():
    rgb, depth = _rgbd(0)
    mask = np.random.RandomState(1).rand(*depth.shape) < 0.8
    for args in ((depth, K), (depth, K, rgb), (depth, K, rgb, mask)):
        for a, b in zip(pc.backproject_depth(*args), jax_pc.backproject_depth(*args)):
            _equal(a, b)
    pts, cols = pc.backproject_depth(depth, K, rgb)
    _equal(pc.transform_points(pts, T), jax_pc.transform_points(pts, T))
    for colors in (cols, None):
        for a, b in zip(pc.voxel_downsample(pts, colors, 0.05),
                        jax_pc.voxel_downsample(pts, colors, 0.05)):
            _equal(a, b)
    empty = np.zeros((0, 3), np.float32)
    assert len(pc.voxel_downsample(empty, None, 0.05)[0]) == 0


@pytest.mark.parametrize("kw", [{}, dict(voxel_size=0.02, min_depth=0.3, max_depth=1.2),
                                dict(extrinsic=T)])
def test_rgbd_to_pointcloud_crop_merge_match_jax(tmp_path, kw):
    rgb, depth = _rgbd(2)
    a = rs.rgbd_to_pointcloud(rgb, depth, K, fname=str(tmp_path / "a.ply"), **kw)
    b = jax_rs.rgbd_to_pointcloud(rgb, depth, K, fname=str(tmp_path / "b.ply"), **kw)
    for x, y in zip(a, b):
        _equal(x, y)
    assert len(a[0]) > 0
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for bounds in ({}, dict(bounds_min=(-0.2, -0.2, 0.3), bounds_max=(0.2, 0.3, 1.0))):
        for cols in (a[1], None):
            for x, y in zip(rs.crop_workspace(a[0], cols, **bounds),
                            jax_rs.crop_workspace(a[0], cols, **bounds)):
                _equal(x, y)
    cols8 = np.clip(a[1], 0, 255).astype(np.uint8)
    _equal(rs.merge_xyz_rgb(a[0], cols8), jax_rs.merge_xyz_rgb(a[0], cols8))


@pytest.mark.parametrize("colors", ["uint8", "unit_float", "float255", "none", "empty"])
def test_write_ply_byte_equal_and_read_back(tmp_path, colors):
    r = np.random.RandomState(3)
    n = 0 if colors == "empty" else 57
    pts = r.standard_normal((n, 3)).astype(np.float64)
    cols = {"uint8": r.randint(0, 256, (n, 3)).astype(np.uint8),
            "unit_float": r.rand(n, 3),
            "float255": r.uniform(0, 300, (n, 3)),
            "none": None,
            "empty": np.zeros((0, 3), np.float64)}[colors]
    pc.write_ply(str(tmp_path / "port.ply"), pts, cols)
    jax_pc.write_ply(str(tmp_path / "jax.ply"), pts, cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got_pts, got_cols = pc.read_ply(str(tmp_path / "port.ply"))
    ref_pts, ref_cols = jax_pc.read_ply(str(tmp_path / "jax.ply"))
    _equal(got_pts, ref_pts)
    _equal(got_cols, ref_cols)
    np.testing.assert_array_equal(got_pts, pts.astype(np.float32))
    assert (got_cols is None) == (cols is None)


def test_viz_cropped_pointcloud_matches_jax(tmp_path):
    rgb, depth = _rgbd(4)
    pc.viz_cropped_pointcloud(K, rgb, depth, str(tmp_path / "a.ply"))
    jax_pc.viz_cropped_pointcloud(K, rgb, depth, str(tmp_path / "b.ply"))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


# ----------------------------------------------------- eval's write_pcd
@dataclasses.dataclass
class _JaxStandIn:
    guidance: object = JaxGuidance(flow_guidance_weight=0.0)
    vae: object = None

    class Out(NamedTuple):
        images: jnp.ndarray
        intermediates: jnp.ndarray

    def __call__(self, key, **kw):
        return self.Out(kw["sim_disp"], kw["sim_disp"][None])


@dataclasses.dataclass
class _PortStandIn:
    guidance: object = FlowGuidance(flow_guidance_weight=0.0)
    vae: object = None
    device: str = "cpu"

    def __call__(self, generator=None, **kw):
        return PipelineOutput(kw["sim_disp"], kw["sim_disp"][None])


def test_eval_write_pcd_matches_jax(tmp_path, monkeypatch):
    from d3roma_tpu.config import load_task_preset as jax_preset
    from d3roma_tpu.data import fetch_dataloader as jax_fetch
    from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
    from d3roma_tpu.ops import Normalizer as JaxNormalizer
    from d3roma_tpu.training.train_loop import _preprocess_eval
    from d3roma_tpu_torch.config import load_task_preset
    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset

    monkeypatch.chdir(tmp_path)
    generate_dataset(str(tmp_path / "datasets" / "HISS"), 4, split="test",
                     config=SceneConfig(height=36, width=64), seed=11)
    jcfg, pcfg = [], []
    for load, out in ((jax_preset, jcfg), (load_task_preset, pcfg)):
        cfg = load("eval_ldm_mixed_rgb+raw")
        for k, v in dict(eval_dataset=["HISS"], camera_resolution="64x36", eval_batch_size=2,
                         num_inference_timesteps=2, ch_bounds=[8.0], write_pcd=True).items():
            setattr(cfg, k, v)
        out.append(cfg)
    (jcfg,), (pcfg,) = jcfg, pcfg
    jax_evaluate(jcfg, _JaxStandIn(), jax_fetch(jcfg)[1][0], jax.random.PRNGKey(0),
                 eval_output_dir=str(tmp_path / "jax"), write_artifacts=True,
                 dataset_name="HISS",
                 preprocess=partial(_preprocess_eval, config=jcfg,
                                    normalizer=JaxNormalizer.from_config(jcfg)))
    evaluate_dataset(pcfg, _PortStandIn(), val_loaders(pcfg)[0], torch.Generator().manual_seed(0),
                     eval_output_dir=str(tmp_path / "port"), write_artifacts=True,
                     dataset_name="HISS",
                     preprocess=partial(preprocess_eval, config=pcfg,
                                        normalizer=Normalizer.from_config(pcfg), device="cpu"))
    for i in range(2):
        name = f"idx{i}_pred.ply"
        assert os.path.exists(tmp_path / "port" / name), name
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        pts, cols = pc.read_ply(str(tmp_path / "port" / name))
        assert len(pts) > 0 and cols is None
