from .train_step import cross_entropy_loss, make_eval_step  # noqa: F401
