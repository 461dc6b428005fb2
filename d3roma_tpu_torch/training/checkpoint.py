"""Checkpoint and resume.

Port of `d3roma_tpu/training/checkpoint.py`. Two artifacts, as in the JAX
package:

- the *train state* (params, optimizer state, loss-aware sampler state,
  step and the seed the draws derive from): `save_state` writes it per epoch to
  `checkpoints/last` (and on anomalies) as `state.pt` through `torch.save`,
  with the StepCounter in `counter.json` as the JAX package writes it;
  `load_state` reads it back with `torch.load(weights_only=True)` into a
  template state. This is the port's own format (the JAX package's is an
  Orbax directory);
- the *pipeline export* (`best/`, `epoch_NNNN/`): `save_pretrained`
  directories, which both packages read.

On a mesh of ranks `save_state` gathers a tensor-parallel state into the
one-process layout first (`TrainState.state_dict`; every rank of a model
group takes part), rank 0 alone writes, and the ranks wait for it: `state.pt`
is the file one process writes, so a run resumes on another topology
(`load_state` reads the whole state; the loop shards it after).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from d3roma_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, barrier
from d3roma_tpu_torch.training.state import StepCounter, TrainState

STATE_FILE = "state.pt"


def save_state(ckpt_dir: str, state: TrainState, counter: StepCounter,
               mesh: Optional[Mesh] = None) -> None:
    """Write the state and the counter (on a mesh: rank 0, after every rank
    of its model group gathered a tensor-parallel state)."""
    lead = mesh is None or mesh.rank == 0
    sd = None
    if state.optimizer.tp > 1:
        if mesh.coord(DATA_AXIS) == 0:  # data rank 0's model group gathers
            sd = state.state_dict()
    elif lead:
        sd = state.state_dict()
    if lead:
        ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, STATE_FILE + ".tmp")
        torch.save(sd, tmp)
        os.replace(tmp, os.path.join(ckpt_dir, STATE_FILE))
        with open(os.path.join(ckpt_dir, "counter.json"), "w") as f:
            json.dump(counter.state_dict(), f)
    barrier(mesh)


def load_state(ckpt_dir: str, template: TrainState) -> Tuple[TrainState, StepCounter]:
    """Load into `template` (in place: its model, optimizer and tensors
    keep their devices) and return it with the saved StepCounter."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    sd = torch.load(os.path.join(ckpt_dir, STATE_FILE), map_location="cpu",
                    weights_only=True)
    template.load_state_dict(sd)
    counter = StepCounter()
    cpath = os.path.join(ckpt_dir, "counter.json")
    if os.path.exists(cpath):
        with open(cpath) as f:
            counter.load_state_dict(json.load(f))
    return template, counter


def latest_checkpoint(root: str) -> Optional[str]:
    last = os.path.join(root, "checkpoints", "last")
    return last if os.path.exists(os.path.join(last, "counter.json")) else None
