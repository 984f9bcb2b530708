"""The port's microbenchmarks, each run as
``python -m fusiontransformer_tpu_torch.tools.<name>``: on the card by
default, on the CPU (plain versions, host times) with ``--device cpu``."""
