"""repro_torch.train — loss, train-step builder, microbatching."""
from .loop import (TrainHyper, init_train_state, loss_fn, make_train_step,  # noqa: F401
                   train_state_from_reference, train_state_specs)
