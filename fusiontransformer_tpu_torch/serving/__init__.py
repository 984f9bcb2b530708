from fusiontransformer_tpu_torch.serving.engine import InferenceEngine

__all__ = ["InferenceEngine"]
