"""Data parallelism over torch.distributed (parallel/ddp.py)."""
