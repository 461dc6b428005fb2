"""Training CLI of the port (the counterpart of the repository's train.py).

    python -m d3roma_tpu_torch.train task=train_ldm_mixed_rgb+raw \
        [key=value ...] [--device cpu] [--seed N]

    torchrun --nproc-per-node N -m d3roma_tpu_torch.train \
        task=train_ldm_mixed_rgb+raw [task.tensor_parallel=T] [key=value ...]

The JAX train.py's contract: the task preset and overrides composed by
`config.compose`, `debug=true` shortening the run (`set_debug`), the
output directory from the config or named after it, `train.log` in it,
and a TensorBoard writer under `tb/` when tensorboardX imports (else a
warning and no scalars). Runs on CUDA unless `--device` names another
device; `--seed` overrides the config's seed (default: the config's, else
0), which seeds the weights, the data order and every step's draws.

Under torchrun (WORLD_SIZE > 1) every rank joins the process group
(`parallel.init_distributed`: NCCL when each rank has a card of its own,
gloo when ranks share one or run on the CPU), logs its mesh coordinates
and backend, and trains its share (`training/train_loop.py`): data
parallel over the ranks, tensor parallel over groups of
`task.tensor_parallel` of them. Rank 0 alone makes the output directory
and writes `train.log`, the scalars, the checkpoints and the exports. On
CUDA a rank that cannot reach its card raises; nothing falls back to the
CPU unless `--device cpu` asks for it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def main(argv) -> int:
    import torch.distributed as dist

    from d3roma_tpu_torch.config import compose, get_output_dir, set_debug
    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.parallel import init_distributed
    from d3roma_tpu_torch.training import train

    parser = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.train")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the weights, the data order and the draws "
                             "(default: the config's, else 0)")
    args, overrides = parser.parse_known_args(argv)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_distributed(args.device)
    else:
        device = resolve_device(args.device)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    lead = rank == 0
    fmt = _FORMAT if world == 1 else f"%(asctime)s [rank {rank}] %(name)s %(levelname)s %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)
    base = compose(overrides)
    config = base.task
    if base.debug:
        set_debug(config)
    if args.seed is not None:
        base.seed = args.seed
    if base.seed is not None and base.seed >= 0:
        import numpy as np

        np.random.seed(base.seed)

    output_dir = config.output_dir or get_output_dir(base)
    config.output_dir = output_dir
    fh, writer = None, None
    if lead:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logging.getLogger().addHandler(fh)
        logging.getLogger().setLevel(logging.INFO)
        logging.info("output dir: %s", output_dir)
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(os.path.join(output_dir, "tb"))
        except Exception:
            logging.warning("tensorboardX unavailable; scalar logging disabled")

    try:
        train(config, base_config=base, output_dir=output_dir, writer=writer, device=device)
    finally:
        if writer is not None:
            writer.close()
        if fh is not None:
            logging.getLogger().removeHandler(fh)
            fh.close()
        if world > 1 and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            # before the interpreter's teardown (gloo's threads can abort a
            # rank at exit otherwise)
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
