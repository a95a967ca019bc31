"""Batch preprocessing, the loss, the optimizer and the train step."""
