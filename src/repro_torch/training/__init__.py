"""Training substrate: optimizers, train loop, checkpointing."""
from repro_torch.training.optimizer import Adam, AdamState, apply_updates, cosine_schedule, global_norm
from repro_torch.training.train_loop import make_train_step, train
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
