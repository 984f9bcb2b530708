"""Data parallelism (``data_parallel.py``), tensor parallelism of the ViT
(``tensor_parallel.py``), ZeRO-1 (``zero.py``) and the GPipe ViT
(``pipeline_parallel.py``) over ``torch.distributed``."""
