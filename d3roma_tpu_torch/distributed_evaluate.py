"""Multi-rank evaluation (the counterpart of the repository's
distributed_evaluate.py).

    torchrun --nproc-per-node N -m d3roma_tpu_torch.distributed_evaluate \
        task=eval_ldm_mixed_rgb+raw task.resume_pretrained=DIR \
        task.eval_dataset=[HISS] [task.tensor_parallel=T] [key=value ...] \
        [--device cpu] [--seed N]

Every rank loads the same batches (the loaders are seed-identical), pads
each to the data axis (`pad_batch_to_devices`, which marks the padded rows
`sample_valid` 0), keeps its rows (`slice_process_local`, `shard_batch`) and
runs the pipeline on them; each batch's per-sample metrics are gathered
across the data axis, so every real sample counts once, in the order a
one-process run takes them, and the padded rows count zero. The noise is
the one-process run's: each rank draws the whole batch's and keeps its rows
(`parallel/mesh.py::data_rows`).

With `task.tensor_parallel=T` the ranks form a (N / T, T) mesh: the batch
shards over the data axis and the UNet's and the VAE's parameters over the
model axis (`shard_pipeline_tp`); as in the JAX script, the
`fast_inference` kernels are then left off (a warning says so). Rank 0
prints one JSON line of metrics per dataset, as `python -m
d3roma_tpu_torch.evaluate` does. Runs on CUDA (NCCL when each rank has a
card, gloo when ranks share one) unless `--device` names the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("d3roma_tpu_torch.distributed_evaluate")


def main(argv) -> int:
    import torch

    from d3roma_tpu_torch.config import compose, deepcache_active, set_debug
    from d3roma_tpu_torch.data import device_preprocess, val_loaders
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.parallel import (
        DATA_AXIS,
        all_gather_cat,
        data_rows,
        init_distributed,
        make_mesh,
        pad_batch_to_devices,
        shard_batch,
        shard_pipeline_tp,
        slice_process_local,
    )
    from d3roma_tpu_torch.pipelines import (
        GuidedDiffusionPipeline,
        GuidedLatentDiffusionPipeline,
        create_sampler_spec,
    )

    parser = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.distributed_evaluate")
    parser.add_argument("--device", default=None, help="torch device type (default: cuda)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the noise generator (default: the config's, else 0)")
    args, overrides = parser.parse_known_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = init_distributed(args.device)
    base = compose(overrides)
    config = base.task
    if base.debug:
        set_debug(config)

    if not (config.resume_pretrained and os.path.exists(config.resume_pretrained)):
        raise SystemExit(f"resume_pretrained not found: {config.resume_pretrained!r}")
    cls = GuidedLatentDiffusionPipeline if config.ldm else GuidedDiffusionPipeline
    pipeline = cls.from_pretrained(config.resume_pretrained, device=device)
    tp = max(1, int(getattr(config, "tensor_parallel", 1) or 1))
    if config.fast_inference != "off" and hasattr(pipeline, "fast_inference"):
        if tp > 1:
            logger.warning("tensor_parallel=%d: fast_inference=%s kernels are not "
                           "TP-validated in the evaluation; using the plain path",
                           tp, config.fast_inference)
        else:
            pipeline = pipeline.fast_inference(config.fast_inference)
    pipeline = pipeline.replace_sampler(create_sampler_spec(config, train=False))
    if ((deepcache_active(config.deepcache) or config.deepcache_depth != 1)
            and hasattr(pipeline, "deepcache")):
        pipeline = pipeline.deepcache(config.deepcache, depth=config.deepcache_depth)

    if tp > 1:
        pipeline, mesh = shard_pipeline_tp(pipeline, tp, logger)
    else:
        mesh = make_mesh(device)
    # tails only need the data axis: padding to every rank would run tp-fold
    # duplicated rows
    n_data = mesh.axis_sizes[DATA_AXIS]
    index = mesh.coord(DATA_AXIS)
    norm = Normalizer.from_config(config)

    def preprocess(raw_batch):
        arrays = {k: v for k, v in raw_batch.items() if not isinstance(v, (list, str))}
        arrays = pad_batch_to_devices(arrays, n_data)
        arrays = slice_process_local(arrays, index, n_data)
        return device_preprocess(shard_batch(arrays, mesh), norm, config.prediction_space)

    def gather_rows(a):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return all_gather_cat(t, mesh, DATA_AXIS, 0).numpy()

    seed = args.seed if args.seed is not None else (base.seed if base.seed >= 0 else 0)
    generator = torch.Generator().manual_seed(seed)
    for name, loader in zip(config.eval_dataset, val_loaders(config)):
        with data_rows(index, n_data):
            metrics, stat = evaluate_dataset(config, pipeline, loader, generator,
                                             preprocess=preprocess, dataset_name=name,
                                             gather_rows=gather_rows)
        if mesh.rank == 0:
            logger.info("[%s] metrics over %d ranks: %s", name, mesh.size, metrics)
            print(json.dumps({"dataset": name, "metrics": metrics,
                              "num_rejected": stat.num_rejected,
                              "ranks": mesh.size, "mesh": mesh.axis_sizes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
