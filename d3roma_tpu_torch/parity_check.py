"""One-command checkpoint-parity harness without JAX.

    python -m d3roma_tpu_torch.parity_check --ref-dir /path/to/released_pipeline \
        [--out-dir _parity] [--ref-metrics ref_metrics.json] [--cond-channels rgb+raw] \
        [--max-batches 4] [--frames 8] [--tol 0.01] [--seed 0] [--image-size HxW] \
        [--steps N] [--device cpu]
    python -m d3roma_tpu_torch.parity_check --pipeline-dir DIR \
        (--golden-dump OUT | --golden-compare OUT) [--golden-size 64x96]

The counterpart of `scripts/parity_check.py`, with its flags, outputs and
exit codes. It imports the reference diffusers directory
(`import_reference`: names, conv_in widening, the empty-prompt CLIP
embedding), evaluates the imported pipeline on procedural HISS frames
generated under OUT_DIR/datasets (`evaluation.evaluate_dataset`), and writes
OUT_DIR/parity.json with the AbsRel reached. With `--ref-metrics` (the
reference implementation's metrics on the same frames, {"rel": x} or
{"depth": {"rel": x}}) it also decides |rel - rel_ref| / rel_ref <= tol and
exits 1 when that fails. Without a diffusers directory at `--ref-dir` (or
D3ROMA_REF_CKPT) it prints a PARITY SKIP line and exits 0, as the JAX
script does. `--golden-dump` / `--golden-compare` run the per-stage golden
harness (`evaluation/golden.py`) on `--pipeline-dir`, or on the imported
pipeline; a compare exits 1 at the first stage that is off. The models run
on `--device` (CUDA unless named).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial


def _is_diffusers_dir(d) -> bool:
    return bool(
        d and os.path.isdir(d)
        and os.path.isdir(os.path.join(d, "unet"))
        and os.path.isdir(os.path.join(d, "vae"))
        and any(os.path.exists(os.path.join(d, "unet", n))
                for n in ("diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.parity_check")
    p.add_argument("--ref-dir", default=os.environ.get("D3ROMA_REF_CKPT"),
                   help="reference diffusers pipeline dir (released weights)")
    p.add_argument("--out-dir", default="_parity")
    p.add_argument("--ref-metrics", default=None,
                   help="JSON with the reference implementation's metrics on the same eval "
                        "frames: {'rel': float, ...}")
    p.add_argument("--cond-channels", default="rgb+raw")
    p.add_argument("--max-batches", type=int, default=4)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--tol", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", default=None, help="HxW override (e.g. 64x96)")
    p.add_argument("--steps", type=int, default=None, help="num_inference_timesteps override")
    p.add_argument("--pipeline-dir", default=None,
                   help="an already imported or exported pipeline dir (from_pretrained "
                        "format): skips the reference import")
    p.add_argument("--golden-dump", default=None, metavar="DIR",
                   help="save per-stage intermediates to DIR and exit")
    p.add_argument("--golden-compare", default=None, metavar="DIR",
                   help="recompute the stages and diff against a prior --golden-dump; "
                        "exits 1 when any stage is off")
    p.add_argument("--golden-size", default="64x96", help="HxW of the golden probe frame")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    if (args.golden_dump or args.golden_compare) and args.pipeline_dir:
        return _golden_main(args)

    if not _is_diffusers_dir(args.ref_dir):
        print(f"PARITY SKIP: no reference checkpoint at {args.ref_dir!r} "
              "(pass --ref-dir or set D3ROMA_REF_CKPT)")
        return 0

    import torch

    from d3roma_tpu_torch.config import load_task_preset
    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.import_reference import main as import_main
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
    from d3roma_tpu_torch.synthetic import generate_dataset

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    # absolute: from_pretrained runs after os.chdir(args.out_dir) below
    imported = os.path.abspath(os.path.join(args.out_dir, "imported_pipeline"))
    print(f"[1/3] importing {args.ref_dir} -> {imported}")
    import_main([args.ref_dir, imported, "--cond-channels", args.cond_channels,
                 "--device", str(device)])

    if args.golden_dump or args.golden_compare:
        args.pipeline_dir = imported
        return _golden_main(args)

    print("[2/3] evaluating the imported pipeline on procedural frames")
    cfg = load_task_preset("eval_ldm_mixed_rgb+raw" if "rgb" in args.cond_channels
                           else "eval_ldm_mixed")
    cfg.resume_pretrained = imported
    cfg.eval_dataset = ["HISS"]
    cfg.eval_split = "test"
    cfg.eval_batch_size = 2
    cfg.eval_num_batch = args.max_batches
    cfg.num_inference_rounds = 1
    if args.image_size:
        h, w = (int(v) for v in args.image_size.split("x"))
        cfg.image_size = (h, w)
        cfg.camera_resolution = f"{w}x{h}"
    if args.steps:
        cfg.num_inference_timesteps = args.steps

    hiss_dir = os.path.join(args.out_dir, "datasets", "HISS")
    if not os.path.exists(hiss_dir):
        generate_dataset(hiss_dir, args.frames, split="test", seed=args.seed)
    cwd = os.getcwd()
    os.chdir(args.out_dir)  # dataset roots are relative to the working directory
    try:
        pipeline = GuidedLatentDiffusionPipeline.from_pretrained(imported, device=device)
        pipeline = pipeline.replace_sampler(create_sampler_spec(cfg, train=False))
        norm = Normalizer.from_config(cfg)
        metrics, _ = evaluate_dataset(
            cfg, pipeline, val_loaders(cfg)[0], torch.Generator().manual_seed(args.seed),
            preprocess=partial(preprocess_eval, config=cfg, normalizer=norm, device=device),
            max_batches=args.max_batches)
    finally:
        os.chdir(cwd)

    rel = float(metrics["depth"]["rel"])
    result = {"imported": imported, "metrics": metrics, "rel": rel}

    print("[3/3] parity decision")
    if args.ref_metrics and os.path.exists(args.ref_metrics):
        with open(args.ref_metrics) as f:
            ref = json.load(f)
        rel_ref = float(ref["rel"] if "rel" in ref else ref["depth"]["rel"])
        delta = abs(rel - rel_ref) / max(rel_ref, 1e-9)
        result.update({"rel_ref": rel_ref, "rel_delta": delta, "tol": args.tol,
                       "pass": bool(delta <= args.tol)})
        print(f"AbsRel ours={rel:.5f} ref={rel_ref:.5f} delta={delta:.2%} tol={args.tol:.0%} "
              f"-> {'PASS' if result['pass'] else 'FAIL'}")
    else:
        result["pass"] = None
        print(f"AbsRel ours={rel:.5f} (no --ref-metrics given: recorded only; produce ref "
              f"metrics with the reference evaluate.py on the frames under "
              f"{os.path.join(args.out_dir, 'datasets')})")

    path = os.path.join(args.out_dir, "parity.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {path}")
    return 0 if result["pass"] in (True, None) else 1


def _golden_main(args) -> int:
    """--golden-dump / --golden-compare on a from_pretrained pipeline."""
    from d3roma_tpu_torch.evaluation import golden
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline

    pipe = GuidedLatentDiffusionPipeline.from_pretrained(args.pipeline_dir, device=args.device)
    h, w = (int(v) for v in args.golden_size.split("x"))
    if args.golden_dump:
        npz = golden.dump(pipe, args.golden_dump, H=h, W=w, seed=args.seed,
                          cond_channels=args.cond_channels)
        print(f"GOLDEN DUMP: wrote {npz}")
        return 0
    report = golden.compare(pipe, args.golden_compare)
    print(json.dumps(report, indent=1))
    bad = [k for k, v in report.items() if not v.get("ok")]
    if bad:
        print(f"GOLDEN COMPARE: FIRST divergent stage = {bad[0]} (all: {bad})")
        return 1
    print("GOLDEN COMPARE: all stages match")
    return 0


if __name__ == "__main__":
    sys.exit(main())
