"""Training of the port: the train state, AdamW as the JAX package's optax
chain, the teacher-forced train step (`train_state.py`), and the training
CLI (`run_training.py` over `arguments.py`, `data.py`, `checkpoints.py` and
`eval_metrics.py`)."""

from .train_state import Batch, TrainState, make_optimizer, make_train_step

__all__ = ["Batch", "TrainState", "make_optimizer", "make_train_step"]
