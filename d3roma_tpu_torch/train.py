"""Training CLI of the port (the counterpart of the repository's train.py).

    python -m d3roma_tpu_torch.train task=train_ldm_mixed_rgb+raw \
        [key=value ...] [--device cpu] [--seed N]

The JAX train.py's contract: the task preset and overrides composed by
`config.compose`, `debug=true` shortening the run (`set_debug`), the
output directory from the config or named after it, `train.log` in it,
and a TensorBoard writer under `tb/` when tensorboardX imports (else a
warning and no scalars). Runs on CUDA unless `--device` names another
device; `--seed` overrides the config's seed (default: the config's, else
0), which seeds the weights, the data order and every step's draws.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv) -> int:
    from d3roma_tpu_torch.config import compose, get_output_dir, set_debug
    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.training import train

    parser = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.train")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the weights, the data order and the draws "
                             "(default: the config's, else 0)")
    args, overrides = parser.parse_known_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    device = resolve_device(args.device)
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
    os.makedirs(output_dir, exist_ok=True)

    fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
    fh.setLevel(logging.INFO)
    fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logging.getLogger().addHandler(fh)
    logging.getLogger().setLevel(logging.INFO)
    logging.info("output dir: %s", output_dir)

    writer = None
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
        logging.getLogger().removeHandler(fh)
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
