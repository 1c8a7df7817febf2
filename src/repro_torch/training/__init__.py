"""Training of the port: AdamW, the LM loss and step, synthetic data and
checkpoints, with JAX's semantics (``repro/training``)."""
from repro_torch.training.optimizer import (adamw_init,  # noqa: F401
                                            adamw_update, OptConfig)
from repro_torch.training.train_loop import (loss_fn,  # noqa: F401
                                             make_train_step, train_step)
