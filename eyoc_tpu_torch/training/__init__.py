"""Batch preprocessing for the test protocol."""
