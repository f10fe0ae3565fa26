"""toad_tpu_torch: the PyTorch/CUDA port of toad_tpu for NVIDIA Hopper.

Attention MIL with two task heads over whole-slide-image feature bags, as in
:mod:`toad_tpu`, which stays the reference this package is tested against.
The plain tensor code is PyTorch; the fused trunk + gated attention +
masked-softmax pooling is a CUDA kernel written by hand for sm_90a
(``csrc/pool.cu``), built with nvcc on first use. Ported so far: the serving
path (``python -m toad_tpu_torch serve``).
"""

from toad_tpu_torch.version import __version__

__all__ = ["__version__"]
