"""Data parallelism over ``torch.distributed`` (``data_parallel.py``)."""
