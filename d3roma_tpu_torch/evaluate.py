"""Evaluation CLI of the port (the counterpart of the repository's evaluate.py).

    python -m d3roma_tpu_torch.evaluate task=eval_ldm_mixed_rgb+raw \
        task.resume_pretrained=DIR task.eval_dataset=[HISS] [key=value ...] \
        [--device cpu] [--seed N]

Loads a pipeline directory (the JAX package's format or the port's own
`save_pretrained`), overrides the sampler from the config, applies
`task.fast_inference` and `task.deepcache`, runs every eval dataset (one
`evaluate_dataset` each, artifacts under the output directory as the JAX
CLI writes them) and prints one JSON line of metrics per dataset:
`{"dataset": name, "metrics": {...}, "num_rejected": n}`. Runs on CUDA
unless `--device` names another device; `--seed` seeds the one generator
every batch's noise is drawn from (default: the config's seed, else 0).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from functools import partial

logger = logging.getLogger("d3roma_tpu_torch.evaluate")


def main(argv) -> int:
    import torch

    from d3roma_tpu_torch.config import compose, deepcache_active, get_output_dir, set_debug
    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import (
        GuidedDiffusionPipeline,
        GuidedLatentDiffusionPipeline,
        create_sampler_spec,
    )

    parser = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.evaluate")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the noise generator (default: the config's, else 0)")
    args, overrides = parser.parse_known_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    base = compose(overrides)
    config = base.task
    if base.debug:
        set_debug(config)

    if not (config.resume_pretrained and os.path.exists(config.resume_pretrained)):
        raise SystemExit(f"resume_pretrained not found: {config.resume_pretrained!r}")
    cls = GuidedLatentDiffusionPipeline if config.ldm else GuidedDiffusionPipeline
    pipeline = cls.from_pretrained(config.resume_pretrained, device=device)
    pipeline = pipeline.replace_sampler(create_sampler_spec(config, train=False))
    if config.fast_inference != "off" and hasattr(pipeline, "fast_inference"):
        pipeline = pipeline.fast_inference(config.fast_inference)
    if ((deepcache_active(config.deepcache) or config.deepcache_depth != 1)
            and hasattr(pipeline, "deepcache")):
        pipeline = pipeline.deepcache(config.deepcache, depth=config.deepcache_depth)

    out_dir = config.eval_output or os.path.join(get_output_dir(base), f"eval_{config.eval_split}")
    os.makedirs(out_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(out_dir, "eval.log"))
    fh.setLevel(logging.INFO)
    logging.getLogger().addHandler(fh)

    loaders = val_loaders(config)
    norm = Normalizer.from_config(config)
    seed = args.seed if args.seed is not None else (base.seed if base.seed >= 0 else 0)
    generator = torch.Generator().manual_seed(seed)

    try:
        for name, loader in zip(config.eval_dataset, loaders):
            metrics, stat = evaluate_dataset(
                config, pipeline, loader, generator,
                eval_output_dir=os.path.join(out_dir, name),
                preprocess=partial(preprocess_eval, config=config, normalizer=norm,
                                   device=device),
                # every artifact-producing flag opens the artifact block
                write_artifacts=(config.plot_error_map or config.write_pcd
                                 or config.plot_denoised_images
                                 or config.plot_intermediate_metrics
                                 or name == "HISS"),
                dataset_name=name,
            )
            logger.info("[%s] metrics: %s", name, metrics)
            logger.info("[%s] rejected %d abnormal samples: %s", name,
                        stat.num_rejected, stat.abnormal_indexes)
            print(json.dumps({"dataset": name, "metrics": metrics,
                              "num_rejected": stat.num_rejected,
                              "output_dir": os.path.join(out_dir, name)}), flush=True)
    finally:
        logging.getLogger().removeHandler(fh)
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
