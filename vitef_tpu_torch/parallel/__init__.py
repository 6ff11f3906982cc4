from .train_step import (  # noqa: F401
    TrainState,
    auto_grad_acc,
    cross_entropy_loss,
    init_train_state,
    make_eval_step,
    make_train_step,
)
