"""The port's bench (`d3roma_tpu_torch/bench.py`, `python -m
d3roma_tpu_torch.bench`): its pure logic, as tests/test_bench_select.py
holds the JAX bench's, with the same cases against the port's module (the
measured-mode autoselect, the DeepCache key, the accuracy-gated default,
the records), and what the JAX bench's tests do not cover: the error line
(no CUDA card, for the latent and the pixel bench), the knobs' parsing,
the pixel bench's int8 setting and the keys of the scale cache. No device
work."""

import importlib
import json
import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV_KEYS = ("BENCH_QUANT", "BENCH_MODEL", "BENCH_BATCH", "BENCH_STEPS",
             "BENCH_FLASH", "BENCH_FF", "BENCH_FUSED_GN", "BENCH_AUTOSELECT",
             "BENCH_CALIB", "BENCH_RECORDS", "BENCH_DEEPCACHE", "BENCH_REPS",
             "BENCH_DEEPCACHE_DEPTH", "BENCH_CLIP_PCT", "BENCH_CACHE_DIR", "BENCH_SEED",
             "D3ROMA_WINO_CHUNK", "D3ROMA_WINO_FUSED", "D3ROMA_WINO_SLAB_MB")


@pytest.fixture(autouse=True)
def _env_guard():
    """The code under test sets os.environ (autoselect's job): snapshot and
    restore, so nothing leaks into later tests."""
    saved = {k: os.environ.get(k) for k in _ENV_KEYS}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _load_bench():
    import d3roma_tpu_torch.bench as bench

    return importlib.reload(bench)


def _set_env(records, **env):
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    os.environ["BENCH_RECORDS"] = str(records)
    env.setdefault("BENCH_DEEPCACHE", "1")
    os.environ.update(env)


def _write_records(path, rows):
    base = dict(model="ldm", batch=16, steps=10, flash="3", ff="1",
                fused_gn="0", wino_fused="", wino_slab="", calib="1",
                wc="0", deepcache="1", ts=0)
    with open(path, "w") as f:
        for row in rows:
            merged = {k: v for k, v in dict(base, **row).items() if v is not None}
            f.write(json.dumps(merged) + "\n")


def test_autoselect_flips_to_measured_winner(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", wc="1", fps=17.8),
    ])
    _set_env(rec)
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") == "wino_static"
    assert os.environ.get("D3ROMA_WINO_CHUNK") == "1"


def test_autoselect_latest_record_wins_not_max(tmp_path):
    """A mode that regressed must not stay pinned by its old fast record."""
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", fps=17.8, ts=1),   # old fast run
        dict(quant="wino_static", fps=14.0, ts=2),   # latest: regressed
    ])
    _set_env(rec)
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None


def test_autoselect_noise_guard_and_static_requirement(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    # within 2% of static -> no flip
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", fps=15.5),
    ])
    _set_env(rec)
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None
    # no static record at this setting -> no flip either
    _write_records(rec, [dict(quant="wino_static", fps=30.0)])
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None


def test_autoselect_respects_setting_and_overrides(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", fps=20.0, batch=1),  # different setting
        dict(quant="wino_static", fps=20.0, wino_fused="0"),  # diff backend
    ])
    _set_env(rec)
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None

    # explicit BENCH_QUANT wins over any record
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", fps=20.0),
    ])
    _set_env(rec, BENCH_QUANT="0")
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") == "0"

    # BENCH_AUTOSELECT=0 disables
    _set_env(rec, BENCH_AUTOSELECT="0")
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None


def test_autoselect_never_overrides_user_wino_chunk(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    _write_records(rec, [
        dict(quant="static", fps=15.3, wc="1"),
        dict(quant="wino_static", fps=20.0, wc="0"),
        dict(quant="wino_static", fps=16.0, wc="1"),
    ])
    _set_env(rec, D3ROMA_WINO_CHUNK="1")
    bench._maybe_autoselect_quant()
    # only wc=1 records are comparable; wino wc=1 beats static wc=1,
    # and the pinned chunk env must survive
    assert os.environ.get("BENCH_QUANT") == "wino_static"
    assert os.environ.get("D3ROMA_WINO_CHUNK") == "1"


def test_autoselect_skips_malformed_records(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    base = dict(model="ldm", batch=16, steps=10, flash="3", ff="1",  # ff tracks bench.DEFAULT_FF
                fused_gn="0", wino_fused="", wino_slab="", calib="1")
    with open(rec, "w") as f:
        f.write("not json\n")
        f.write(json.dumps(dict(base, quant="wino_static")) + "\n")  # no fps
        f.write(json.dumps(dict(base, quant="wino_static",
                                fps="fast")) + "\n")  # non-numeric
        f.write(json.dumps(dict(base, quant="static", fps=15.3)) + "\n")
    _set_env(rec)
    bench._maybe_autoselect_quant()  # must not raise
    assert os.environ.get("BENCH_QUANT") is None


def test_autoselect_never_escalates_deepcache(tmp_path):
    """deepcache is NOT an autoselect dimension (advisor r3): the interval
    changes the model's numerics, and the speed records carry no accuracy
    — a recorded faster run at a lossier interval must never flip the
    default run's interval. Only records at THIS run's interval are
    comparable, and they may govern quant/wc only."""
    bench = _load_bench()
    rec = tmp_path / "results.jsonl"
    _write_records(rec, [
        dict(quant="static", fps=15.3),                  # default interval
        dict(quant="static", deepcache="8", fps=24.5),   # measured faster
        dict(quant="wino_static", deepcache="8", fps=30.0),
    ])
    _set_env(rec)
    bench._maybe_autoselect_quant()
    # the k=8 records are invisible: no quant flip, no schedule change
    assert os.environ.get("BENCH_QUANT") is None
    assert os.environ.get("BENCH_DEEPCACHE") == "1"

    # a user-pinned interval restricts comparisons to that interval and
    # survives; quant autoselect still works within it
    _write_records(rec, [
        dict(quant="static", deepcache="2", fps=19.5),
        dict(quant="static", deepcache="3", fps=25.0),
        dict(quant="wino_static", deepcache="2", fps=21.0),
    ])
    _set_env(rec, BENCH_DEEPCACHE="2")
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") == "wino_static"
    assert os.environ.get("BENCH_DEEPCACHE") == "2"

    # records without the field predate the feature = interval 1 (exact)
    # and are comparable iff this run's interval is 1
    _write_records(rec, [
        dict(quant="static", fps=15.3),
        dict(quant="wino_static", fps=30.0, ts=1, deepcache=None),
    ])
    _set_env(rec, BENCH_DEEPCACHE="1")
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") == "wino_static"
    assert os.environ.get("BENCH_DEEPCACHE") == "1"


def test_default_deepcache_is_accuracy_gated():
    """bench.DEFAULT_DEEPCACHE may only name a schedule (uniform
    interval OR an F/S pattern string, optionally with
    DEFAULT_DEEPCACHE_DEPTH) whose measured drift — on the COMBINED
    shipped config (DeepCache x the default int8 path) — is inside the
    <1% AbsRel parity bar (BASELINE.md), as committed at
    docs/deepcache_accuracy.json under the sweep harness's config key
    ("2", "FSFSFSFSFF", "2d2", ...). "1" (exact) is always admissible.
    Speed records never move the constant; this test is the coupling the
    advisor asked for."""
    bench = _load_bench()
    dc = bench.DEFAULT_DEEPCACHE
    depth = getattr(bench, "DEFAULT_DEEPCACHE_DEPTH", "1")
    if dc == "1" and depth == "1":
        return  # exact numerics — nothing to gate
    cfg_key = dc + (f"d{depth}" if depth != "1" else "")
    table_path = os.path.join(_REPO, "docs", "deepcache_accuracy.json")
    assert os.path.exists(table_path), (
        f"DEFAULT_DEEPCACHE={cfg_key} requires a committed measured "
        f"drift table at {table_path}")
    with open(table_path) as f:
        doc = json.load(f)
    rows = doc["combined_int8"] if "combined_int8" in doc else doc["table"]
    assert cfg_key in rows, (
        f"DEFAULT_DEEPCACHE={cfg_key} has no measured combined-int8 row "
        f"in {table_path} — run scripts/deepcache_accuracy.py with "
        f"DC_KS=1,{cfg_key}")
    row = rows[cfg_key]
    assert abs(row["depth_rel_drift_pct"]) < 1.0, (
        f"config {cfg_key} AbsRel drift {row['depth_rel_drift_pct']}% "
        f"exceeds the 1% parity bar — demote DEFAULT_DEEPCACHE")


def test_record_result_roundtrip(tmp_path):
    bench = _load_bench()
    rec = tmp_path / "sub" / "results.jsonl"
    _set_env(rec, BENCH_QUANT="wino_static", D3ROMA_WINO_CHUNK="1")
    bench._record_result(18.123456)
    with open(rec) as f:
        row = json.loads(f.read())
    assert row["quant"] == "wino_static" and row["wc"] == "1"
    assert row["deepcache"] == bench._deepcache_key()
    assert row["fps"] == 18.123
    # a fresh default run sees the single wino record, no static -> no flip
    _set_env(rec)
    bench._maybe_autoselect_quant()
    assert os.environ.get("BENCH_QUANT") is None


def test_defaults_match_the_jax_bench():
    """The port's defaults are the JAX bench's: static int8, the fused
    GEGLU, DeepCache 2d2, the metric's name and the baseline."""
    bench = _load_bench()
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    import bench as jax_bench

    for name in ("DEFAULT_QUANT", "DEFAULT_FF", "DEFAULT_DEEPCACHE", "BASELINE_FPS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    assert bench._metric_name() == "depth_fps_per_chip_640x360_10step"
    assert bench._parse_deepcache() == (2, 2)
    os.environ["BENCH_DEEPCACHE"] = "FSFSFSFSFF"
    assert bench._parse_deepcache() == ("FSFSFSFSFF", 1)
    os.environ["BENCH_DEEPCACHE"] = "fsfsd2"
    assert bench._parse_deepcache() == ("FSFS", 2)
    os.environ["BENCH_DEEPCACHE"] = "1d2"
    assert bench._parse_deepcache() == (1, 1)
    os.environ["BENCH_DEEPCACHE"] = "2x"
    with pytest.raises(ValueError):
        bench._parse_deepcache()
    assert [bench._flash_route(f) for f in "01234"] == [False, True, "pallas",
                                                        "pallas-self", "fused"]


def test_scale_cache_is_the_ports_own(tmp_path):
    """The calibrated scales are cached under the port's own name
    (torch_act_scales3_*), keyed as the JAX bench keys its files: a table
    the JAX bench captured never replays in the port by accident."""
    bench = _load_bench()
    _set_env(tmp_path / "r.jsonl", BENCH_CACHE_DIR=str(tmp_path), BENCH_CLIP_PCT="0.999",
             D3ROMA_WINO_CHUNK="1")
    path = bench._scales_path("wino_static", 16, 10, "2d2")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == \
        "torch_act_scales3_wino_static_b16_s10_ff1_fl3_dc2d2_q0.999_wc1.json"
    assert os.path.basename(bench._scales_path("static", 2, 10, "1")) == \
        "torch_act_scales3_static_b2_s10_ff1_fl3_dc1_q0.999.json"
    for k in ("BENCH_RECORDS", "BENCH_CACHE_DIR"):
        os.environ.pop(k)
    assert bench._records_path() == os.path.join(_REPO, ".bench_cache", "torch_results.jsonl")


@pytest.mark.parametrize("env", [{}, {"BENCH_MODEL": "pixel"}])
def test_error_line_and_exit(tmp_path, capsys, env):
    """Without a CUDA card (this CPU-only test run), the latent bench and the
    pixel bench (BENCH_MODEL=pixel) alike print the bench's error line,
    value 0, and return 1: no fallback to the CPU, no record written."""
    bench = _load_bench()
    _set_env(tmp_path / "results.jsonl", BENCH_BATCH="1", BENCH_REPS="1", **env)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run")
    assert bench.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["metric"] == "depth_fps_per_chip_640x360_10step" and line["unit"] == "frames/s"
    assert line["error"].startswith("RuntimeError"), line["error"]
    assert "CUDA" in line["error"]
    assert not (tmp_path / "results.jsonl").exists()


def test_pixel_bench_record_names_the_jax_setting(tmp_path):
    """BENCH_MODEL=pixel runs the JAX bench's one pixel setting: its record
    names the model and, as the JAX line does, BENCH_QUANT's value (unused
    by the pixel run; "static" when unset)."""
    bench = _load_bench()
    _set_env(tmp_path / "r.jsonl", BENCH_MODEL="pixel")
    bench._record_result(3.25)
    os.environ["BENCH_QUANT"] = "0"
    bench._record_result(3.5)
    recs = [json.loads(r) for r in (tmp_path / "r.jsonl").read_text().splitlines()]
    assert [(r["model"], r["quant"], r["fps"]) for r in recs] == [
        ("pixel", bench.DEFAULT_QUANT, 3.25), ("pixel", "0", 3.5)]
    assert bench.DEFAULT_QUANT == "static"
