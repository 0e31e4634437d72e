"""Training: the trainer, its optimizers and schedules, and metrics."""
