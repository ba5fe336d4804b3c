from .step import make_train_step, make_loss_fn  # noqa: F401
