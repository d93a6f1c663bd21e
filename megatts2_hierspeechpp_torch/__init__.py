"""PyTorch / CUDA (H100) port of the HierSpeech++ decode path.

Counterpart of the JAX package `megatts2_hierspeechpp_tpu`, which stays the
reference. Module files mirror the JAX package's layout; tensors at public
entry points keep the JAX layout (B, T, C).
"""
from megatts2_hierspeechpp_torch.device import resolve_device

__all__ = ["resolve_device"]
