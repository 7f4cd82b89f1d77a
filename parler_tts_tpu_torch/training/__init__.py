"""Training of the port: the train state, AdamW as the JAX package's optax
chain, and the teacher-forced train step (`train_state.py`)."""

from .train_state import Batch, TrainState, make_optimizer, make_train_step

__all__ = ["Batch", "TrainState", "make_optimizer", "make_train_step"]
