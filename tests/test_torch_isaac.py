"""The port's Isaac replicator package (`d3roma_tpu_torch/synthetic/isaac/`)
against the JAX package's, on the CPU. Both are numpy, so everything is
held exactly:

- geometry, materials, the CAD catalog and the DREDS protocol: the same
  functions on inputs and generators made from a seed give equal arrays
  and dicts, parametrised over seeds;
- the writers: phase gating, duplicate-tick suppression, disparity through
  fxb and the wrong-baseline refusal (as tests/test_isaac_replicator.py
  checks the JAX writers), and every file kind decoded equal to the JAX
  writers' (which write PNGs with cv2 after an RGB -> BGR swap);
- the replicator end to end on the SimBackend at 36x64 (two surfaces, two
  frames each, disparity on): the same seed gives the JAX tree's file
  list, its `meta_*.json` and its decoded PNG and EXR arrays (compared as
  arrays, not bytes). The JAX tree is rendered once per module."""

import glob
import json
import os

import numpy as np
import pytest

from d3roma_tpu.synthetic import isaac as jax_isaac
from d3roma_tpu.synthetic.isaac import assets as jax_assets
from d3roma_tpu.synthetic.isaac import dreds_protocol as jax_dreds
from d3roma_tpu.synthetic.isaac import geometry as jax_geometry
from d3roma_tpu.synthetic.isaac import materials as jax_materials
from d3roma_tpu.synthetic.procedural import SceneConfig as JaxSceneConfig
from d3roma_tpu_torch.synthetic import isaac
from d3roma_tpu_torch.synthetic.isaac import assets, dreds_protocol, geometry, materials
from d3roma_tpu_torch.synthetic.procedural import SceneConfig
from d3roma_tpu_torch.utils.exr import read_exr
from d3roma_tpu_torch.utils.png import read_png

SEEDS = (0, 1, 2)
HW = (36, 64)


def _equal(a, b, path="") -> None:
    """Exact equality of nested dicts, lists, tuples, arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _rotation(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("seed", SEEDS)
def test_geometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    centroid, axes, he = rng.normal(size=3), _rotation(rng), rng.uniform(0.1, 1.0, 3)
    for name in ("obb_corners", "mesh_center_from_obb"):
        _equal(getattr(geometry, name)(centroid, axes, he),
               getattr(jax_geometry, name)(centroid, axes, he), name)
    _equal(geometry.surface_center_from_obb(centroid, axes, he),
           jax_geometry.surface_center_from_obb(centroid, axes, he))
    for R in (_rotation(rng), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        _equal(geometry.mat2quat(R), jax_geometry.mat2quat(R))
        _equal(geometry.mat2euler_sxyz(R), jax_geometry.mat2euler_sxyz(R))
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    _equal(geometry.quat2mat(q), jax_geometry.quat2mat(q))
    pos, target = rng.normal(size=3), rng.normal(size=3)
    _equal(geometry.look_at_quaternion(pos, target), jax_geometry.look_at_quaternion(pos, target))
    straight_down = pos - np.array([0.0, 0.0, 1.0])
    _equal(geometry.look_at_quaternion(pos, straight_down),
           jax_geometry.look_at_quaternion(pos, straight_down))
    ours = geometry.camera_orbit_poses(np.random.default_rng(seed), centroid, 5, (0.5, 1.5),
                                       (10.0, 80.0))
    ref = jax_geometry.camera_orbit_poses(np.random.default_rng(seed), centroid, 5, (0.5, 1.5),
                                          (10.0, 80.0))
    _equal(ours, ref)
    placement = {"rgb_to_left_ir": -0.0275, "rgb_to_right_ir": 0.0275,
                 "rgb_to_projector": 0.01}
    _equal(geometry.rig_pose_from_camera(*ours[0], placement),
           jax_geometry.rig_pose_from_camera(*ref[0], placement))
    sensor = {"resolution": (640, 360), "fov": float(rng.uniform(50, 90))}
    _equal(geometry.stereo_rig_camera_params(sensor), jax_geometry.stereo_rig_camera_params(sensor))


@pytest.mark.parametrize("seed", SEEDS)
def test_materials_match_jax(seed):
    probs = tuple(np.random.default_rng(seed).dirichlet(np.ones(3)))
    ours, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    _equal(materials.assign_materials(ours, 9, probs),
           jax_materials.assign_materials(ref, 9, probs))
    for cls in ("specular", "transparent", "raw", "diffuse"):
        _equal(materials.sample_material_spec(ours, cls),
               jax_materials.sample_material_spec(ref, cls))
    _equal(materials.sample_scene_materials(ours, 12, probs),
           jax_materials.sample_scene_materials(ref, 12, probs))
    assert materials.MATERIAL_CLASSES == jax_materials.MATERIAL_CLASSES
    with pytest.raises(ValueError, match="unknown material class"):
        materials.sample_material_spec(ours, "velvet")


def _cad_tree(root) -> str:
    """A fake DREDS CAD catalog: both layouts, every protocol class."""
    for cls, n in (("bottle", 2), ("bowl", 1), ("mug", 2), ("can", 1), ("camera", 1),
                   ("car", 1), ("other", 4)):
        for i in range(n):
            d = root / "cad" / cls / (f"inst{i}" if i % 2 == 0 else "")
            d.mkdir(parents=True, exist_ok=True)
            (d / f"model{i}.usd").write_text("")
    (root / "cad" / "mug" / "notes.txt").write_text("")
    return str(root / "cad")


@pytest.mark.parametrize("seed", SEEDS)
def test_assets_match_jax(seed, tmp_path):
    cad = _cad_tree(tmp_path)
    catalog = assets.scan_cad_catalog(cad)
    _equal(catalog, jax_assets.scan_cad_catalog(cad))
    assert len(catalog) == 12 and assets.scan_cad_catalog(str(tmp_path / "none")) == []
    _equal(assets.sample_cad_models(np.random.default_rng(seed), cad, 6),
           jax_assets.sample_cad_models(np.random.default_rng(seed), cad, 6))
    _equal(assets.CLASS_SCALES, jax_assets.CLASS_SCALES)


@pytest.mark.parametrize("seed", SEEDS)
def test_dreds_protocol_matches_jax(seed, tmp_path):
    catalog = assets.scan_cad_catalog(_cad_tree(tmp_path))
    ours, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    for cls in ("bottle", "can", "camera", "other") * 4:
        _equal(dreds_protocol.dreds_material_type(ours, cls),
               jax_dreds.dreds_material_type(ref, cls))
    _equal(dreds_protocol.dreds_select_models(ours, catalog),
           jax_dreds.dreds_select_models(ref, catalog))
    anchor = ours.normal(size=3)
    ref.normal(size=3)
    _equal(dreds_protocol.sample_placement(ours, anchor, 2),
           jax_dreds.sample_placement(ref, anchor, 2))
    lighting = dreds_protocol.sample_lighting(ours, ("Sphere", "Disk", "Rect"))
    _equal(lighting, jax_dreds.sample_lighting(ref, ("Sphere", "Disk", "Rect")))
    _equal(dreds_protocol.tick_intensities(lighting, 3), jax_dreds.tick_intensities(lighting, 3))
    for name in ("CLASS_SCALE_RANGES", "CLASS_MATERIAL_PAIRS", "TRANSPARENT_CLASSES",
                 "LIGHT_TABLES"):
        _equal(getattr(dreds_protocol, name), getattr(jax_dreds, name), name)


# ----------------------------------------------------------------- writers


def test_writers_gate_on_ticker_phase(tmp_path):
    fb = isaac.FileBackend(str(tmp_path))
    ticker = isaac.FrameTicker()
    cw, iw = isaac.ColorWriter(fb, ticker), isaac.IRWriter(fb, ticker)
    rgb = np.random.default_rng(0).integers(0, 256, (8, 10, 3), dtype=np.uint8)
    ticker.phase = "ir"
    cw.write({"rgb_RenderProduct_CameraRGB": rgb})  # wrong phase: no file
    assert not glob.glob(str(tmp_path / "*_color.png"))
    ticker.phase = "rgb"
    cw.write({"rgb_RenderProduct_CameraRGB": rgb})
    assert np.array_equal(read_png(str(tmp_path / "0000_color.png")), rgb)
    iw.write({"rgb_Camera01": rgb})  # wrong phase
    ticker.phase = "ir"
    iw.write({"rgb_Camera01": rgb, "rgb_Camera02": rgb[::-1]})
    left = read_png(str(tmp_path / "0000_ir_l.png"))
    assert left.ndim == 2 and np.array_equal(
        left, jax_isaac.writers.rgb2gray(rgb).astype(np.uint8))
    assert np.array_equal(read_png(str(tmp_path / "0000_ir_r.png")),
                          isaac.writers.rgb2gray(rgb[::-1]).astype(np.uint8))


def test_gt_writer_dup_suppression_and_disparity(tmp_path):
    cfg = isaac.ReplicatorConfig()
    fb = isaac.FileBackend(str(tmp_path))
    ticker = isaac.FrameTicker()
    gw = isaac.GtWriter(fb, ticker, render_disparity=True, depth_sensor_cfg=cfg.depth_sensor_cfg)
    depth = np.full((6, 8), 2.0, np.float32)
    ticker.phase, ticker.step = "gt", 1
    gw.write({"distance_to_image_plane": depth})
    gw.write({"distance_to_image_plane": depth})  # duplicate tick: suppressed
    ticker.step = 2
    gw.write({"distance_to_image_plane": depth})
    ticker.phase, ticker.step = "rgb", 3
    gw.write({"distance_to_image_plane": depth})  # wrong phase
    seqs = sorted(os.path.basename(s) for s in glob.glob(str(tmp_path / "*_depth.exr")))
    assert seqs == ["0000_depth.exr", "0001_depth.exr"]
    focal = cfg.resolution[0] / (2 * np.tan(np.radians(cfg.fov_deg) / 2))
    np.testing.assert_allclose(read_exr(str(tmp_path / "0000_disp.exr")), focal * 0.055 / 2.0,
                               rtol=1e-6)


def test_gt_writer_rejects_wrong_baseline(tmp_path):
    cfg = isaac.ReplicatorConfig(baseline=0.06)
    with pytest.raises(AssertionError, match="baseline"):
        isaac.GtWriter(isaac.FileBackend(str(tmp_path)), isaac.FrameTicker(),
                       render_disparity=True, depth_sensor_cfg=cfg.depth_sensor_cfg)


def test_every_file_kind_decodes_as_the_jax_writers(tmp_path):
    """RGBA colour, gray IR, depth and disparity EXRs, a uint16 mask with
    its labels, normals and a point cloud, from one set of annotator
    arrays through both packages' writers."""
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (6, 9, 4), dtype=np.uint8)
    data = {
        "gt": {"distance_to_image_plane": rng.uniform(0.3, 3.0, (6, 9)).astype(np.float32),
               "semantic_segmentation": {"data": rng.integers(0, 4000, (6, 9)),
                                         "idToLabels": {3: {"class": "mug"}}},
               "normals": rng.uniform(-1, 1, (6, 9, 3)).astype(np.float32),
               "pointcloud": rng.normal(size=(20, 3))},
        "rgb": {"rgb_RenderProduct_CameraRGB": rgba},
        "ir": {"rgb_Camera01": rgba, "rgb_Camera02": rgba[::-1]},
    }
    cfg = isaac.ReplicatorConfig().depth_sensor_cfg
    for pkg, out in ((isaac, tmp_path / "port"), (jax_isaac, tmp_path / "jax")):
        fb, ticker = pkg.FileBackend(str(out)), pkg.FrameTicker()
        writers = {"gt": pkg.GtWriter(fb, ticker, render_disparity=True, depth_sensor_cfg=cfg),
                   "rgb": pkg.ColorWriter(fb, ticker), "ir": pkg.IRWriter(fb, ticker)}
        for phase in ("gt", "rgb", "ir"):
            ticker.phase, ticker.step = phase, ticker.step + 1
            writers[phase].write(data[phase])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 9
    for name in names:
        a, b = str(tmp_path / "port" / name), str(tmp_path / "jax" / name)
        if name.endswith(".png"):
            _equal(read_png(a), read_png(b), name)
        elif name.endswith(".exr"):
            _equal(read_exr(a), read_exr(b), name)
        elif name.endswith(".json"):
            _equal(json.load(open(a)), json.load(open(b)), name)
        else:
            _equal(np.load(a), np.load(b), name)
    assert read_png(str(tmp_path / "port" / "0000_color.png")).shape == (6, 9, 3)
    assert read_png(str(tmp_path / "port" / "0000_mask.png")).dtype == np.uint16


# -------------------------------------------------------------- replicator


def _render(pkg, scene_cfg, out, seed=5):
    cfg = pkg.ReplicatorConfig(out_root=str(out), frames_per_surface=2,
                               resolution=HW[::-1], render_disparity=True)
    backend = pkg.SimBackend(scene_cfg(height=HW[0], width=HW[1]), seed=seed)
    return pkg.IsaacReplicator(cfg, seed=seed, backend=backend).start(max_surfaces=2)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("isaac_jax") / "hiss"
    assert _render(jax_isaac, JaxSceneConfig, out) == 4
    return out


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("isaac_port") / "hiss"
    assert _render(isaac, SceneConfig, out) == 4
    return out


def test_replicator_writes_the_jax_file_list_and_meta(jax_tree, port_tree):
    names = sorted(os.listdir(jax_tree))
    assert sorted(os.listdir(port_tree)) == names
    assert {"meta_0.json", "meta_2.json", "0003_ir_r.png", "0003_disp.exr"} <= set(names)
    for name in ("meta_0.json", "meta_2.json"):
        _equal(json.load(open(port_tree / name)), json.load(open(jax_tree / name)), name)
    assert json.load(open(port_tree / "meta_2.json"))["surface"]["category"] == "counter"


@pytest.mark.parametrize("kind", ["color.png", "ir_l.png", "ir_r.png", "depth.exr", "disp.exr"])
def test_replicator_frames_decode_as_the_jax_tree(jax_tree, port_tree, kind):
    read = read_png if kind.endswith(".png") else read_exr
    for i in range(4):
        name = f"{i:04d}_{kind}"
        ours, ref = read(str(port_tree / name)), read(str(jax_tree / name))
        assert ours.shape[:2] == HW
        _equal(ours, ref, name)


def test_sim_backend_protocol():
    """The backend's own guards and its light-tick brightness: RGB only
    with the projector off, IR only with it on, one frame per pose."""
    b = isaac.SimBackend(SceneConfig(height=HW[0], width=HW[1]), seed=1)
    with pytest.raises(AssertionError, match="set_camera_pose"):
        b.render("gt")
    pose = (np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0, 0.0]))
    b.set_camera_pose(*pose)
    first = b.render("gt")["distance_to_image_plane"]
    b.set_camera_pose(*pose)
    assert b.render("gt")["distance_to_image_plane"] is first  # cached per pose
    b.set_projector(True)
    with pytest.raises(AssertionError, match="projector must be off"):
        b.render("rgb")
    assert b.render("ir")["rgb_Camera01"].shape == HW + (3,)
    b.set_projector(False)
    b.create_scene_light({"type": "Sphere"}, np.zeros(3))
    bright = b.render("rgb")["rgb_RenderProduct_CameraRGB"]
    b.set_scene_light_tick(500.0, 10.0)
    dim = b.render("rgb")["rgb_RenderProduct_CameraRGB"]
    assert dim.dtype == bright.dtype and dim.astype(int).sum() < bright.astype(int).sum()
    with pytest.raises(ValueError):
        b.render("thermal")
