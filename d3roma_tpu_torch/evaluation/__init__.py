"""Evaluation: the eval loop, the running averager and the golden stages."""

from d3roma_tpu_torch.evaluation.averager import RunningAverager  # noqa: F401
from d3roma_tpu_torch.evaluation.eval_loop import (  # noqa: F401
    denormalize,
    eval_batch,
    eval_sliced_batch,
    evaluate_dataset,
    evaluate_intermediate_metrics,
)
