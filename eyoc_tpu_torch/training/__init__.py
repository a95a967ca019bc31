"""Batch preprocessing, the losses, the optimizers, the train steps, checkpoints and the trainers."""
