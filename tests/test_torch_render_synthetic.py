"""The port's launcher, `python -m d3roma_tpu_torch.render_synthetic`,
against `scripts/render_synthetic.py`, on the CPU (the SimBackend; Isaac
Sim is absent):

- the committed `conf/synthetic/hssd.yaml` parses through `utils/yaml_lite.py`
  equal to `yaml.safe_load` (trailing comments, an empty value, flow lists,
  a comment line inside a mapping), and a construct outside the subset
  still raises `YamlError`;
- as tests/test_render_synthetic.py checks the JAX launcher: the YAML knobs
  reach the replicator's config, a negative seed draws a fresh one and a
  non-negative one pins it, `--backend omni` fails loudly, a bad override
  is refused;
- the same arguments give the JAX launcher's tree exactly: its file list,
  `meta_*.json` and decoded PNG and EXR arrays (36x64, one surface of two
  frames, disparity on), in process and from the module's own process."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from d3roma_tpu_torch import render_synthetic
from d3roma_tpu_torch.utils import yaml_lite
from d3roma_tpu_torch.utils.exr import read_exr
from d3roma_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from scripts import render_synthetic as jax_launcher  # noqa: E402

HSSD = os.path.join(REPO, "conf", "synthetic", "hssd.yaml")
ARGS = ["--backend", "sim", "depth_sensor.resolution=[64, 36]", "num_frames_per_surface=2",
        "max_surfaces=1", "writer_config.disparity=true", "seed=7"]


def _hssd() -> dict:
    return yaml_lite.load_file(HSSD)


def test_hssd_yaml_parses_as_pyyaml():
    with open(HSSD) as f:
        ref = yaml.safe_load(f)
    assert _hssd() == ref
    assert ref["max_surfaces"] is None and ref["depth_sensor"]["resolution"] == [640, 360]


@pytest.mark.parametrize("text", [
    "a: 1 # trailing comment\nb:\nc: [640, 360] # size\n",
    "backend: auto # one\n              # two, a comment line alone\nseed: -1\n",
    "scene:\n  usd: \"\" # empty\n  hide: [ceiling, wall]\n",
])
def test_yaml_lite_comments_empty_values_and_flow_lists(text):
    assert yaml_lite.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: {b: 1}\n", "a: &x 1\n", "a: |\n  text\n",
                                  "a: [[1, 2]]\n", "- a: 1\n"])
def test_yaml_lite_refuses_what_is_outside_the_subset(text):
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.loads(text)


def test_yaml_knobs_reach_replicator_config():
    cfg = _hssd()
    rep, _ = render_synthetic.build_replicator(cfg, backend="sim")
    assert rep.cfg.resolution == (640, 360)
    assert rep.cfg.fov_deg == pytest.approx(71.28)
    assert rep.cfg.baseline == pytest.approx(0.055)
    assert rep.cfg.frames_per_surface == 3
    render_synthetic.apply_overrides(cfg, ["depth_sensor.fov=90.0", "rt_subframes=2",
                                           "scene.hide_prims=[wall]", "layout.max_objects=4"])
    rep, _ = render_synthetic.build_replicator(cfg, backend="sim")
    assert rep.cfg.fov_deg == 90.0 and rep.cfg.rt_subframes == 2
    assert rep.cfg.hide_prim_names == ("wall",) and rep.cfg.max_objects == 4
    jcfg = yaml.safe_load(open(HSSD))
    jax_launcher.apply_overrides(jcfg, ["depth_sensor.fov=90.0", "rt_subframes=2",
                                        "scene.hide_prims=[wall]", "layout.max_objects=4"])
    assert cfg == jcfg


def test_negative_seed_randomizes_positive_pins():
    cfg = _hssd()
    assert cfg["seed"] == -1  # the committed default
    _, s1 = render_synthetic.build_replicator(dict(cfg), backend="sim")
    _, s2 = render_synthetic.build_replicator(dict(cfg), backend="sim")
    assert s1 != s2
    render_synthetic.apply_overrides(cfg, ["seed=123"])
    _, s3 = render_synthetic.build_replicator(cfg, backend="sim")
    assert s3 == 123


def test_omni_backend_required_fails_loudly():
    with pytest.raises(ImportError, match="Isaac Sim"):
        render_synthetic.build_replicator(_hssd(), backend="omni")
    with pytest.raises(SystemExit, match="unknown backend"):
        render_synthetic.build_replicator(dict(_hssd(), backend="vulkan"))


def test_bad_override_rejected():
    with pytest.raises(SystemExit):
        render_synthetic.apply_overrides({}, ["no_equals_sign"])
    with pytest.raises(SystemExit, match="non-dict"):
        render_synthetic.apply_overrides({"seed": 3}, ["seed.x=1"])


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("launcher_jax") / "hiss"
    assert jax_launcher.main(ARGS + [f"writer_config.output_dir={out}"]) == 0
    return out


def _same_tree(ours, ref) -> None:
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 11  # 2 frames x 5 files + meta
    for name in names:
        a, b = str(ours / name), str(ref / name)
        if name.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), name
            continue
        read = read_png if name.endswith(".png") else read_exr
        x, y = read(a), read(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_launcher_writes_the_jax_tree(jax_tree, tmp_path):
    out = tmp_path / "hiss"
    assert render_synthetic.main(ARGS + [f"writer_config.output_dir={out}"]) == 0
    _same_tree(out, jax_tree)


def test_launcher_module_writes_the_jax_tree(jax_tree, tmp_path):
    out = tmp_path / "hiss"
    proc = subprocess.run([sys.executable, "-m", "d3roma_tpu_torch.render_synthetic"] + ARGS
                          + [f"writer_config.output_dir={out}"], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == f"wrote 2 frames (seed 7) -> {out}"
    assert len(lines) == 2 and lines[1].endswith(" s/frame") and float(lines[1].split()[0]) > 0
    _same_tree(out, jax_tree)
