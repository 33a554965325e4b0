"""Training: precision policy, train/eval/predict steps, optimizers, the
epoch loop and checkpoints."""

from .checkpoint import Checkpoint, EarlyStopping, load_checkpoint, save_checkpoint  # noqa: F401
from .loop import evaluate, test, train_epoch, train_validate_test  # noqa: F401
from .optimizer import (  # noqa: F401
    ReduceLROnPlateau,
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
)
from .step import (  # noqa: F401
    KNOWN_PRECISIONS,
    TrainState,
    create_train_state,
    make_eval_step,
    make_predict_step,
    make_train_step,
    resolve_precision,
)

__all__ = [
    "Checkpoint",
    "EarlyStopping",
    "KNOWN_PRECISIONS",
    "ReduceLROnPlateau",
    "TrainState",
    "create_train_state",
    "evaluate",
    "get_learning_rate",
    "load_checkpoint",
    "make_eval_step",
    "make_predict_step",
    "make_train_step",
    "resolve_precision",
    "save_checkpoint",
    "select_optimizer",
    "set_learning_rate",
    "test",
    "train_epoch",
    "train_validate_test",
]
