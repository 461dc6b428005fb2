"""Training: the train state and optimizer chain, the train step, the
checkpoints, the abnormal-loss forensics and the training loop."""

from d3roma_tpu_torch.training.state import (  # noqa: F401
    ChainOptimizer,
    StepCounter,
    TrainState,
    build_lr_schedule,
    build_optimizer,
    create_train_state,
)
from d3roma_tpu_torch.training.train_step import make_train_step  # noqa: F401
from d3roma_tpu_torch.training.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_state,
    save_state,
)
from d3roma_tpu_torch.training.forensics import AbnormalLossDetector  # noqa: F401
from d3roma_tpu_torch.training.train_loop import build_models, create_pipeline, train  # noqa: F401
