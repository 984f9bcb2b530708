from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.serving.server import InferenceServer

__all__ = ["InferenceEngine", "InferenceServer"]
