"""The MIL model, the patch encoders and weight interop."""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32_convs(dtype: torch.dtype):
    """cuDNN's float32 convolutions in full float32 inside the block: with
    ``dtype`` float32, ``torch.backends.cudnn.allow_tf32`` is False there and
    is put back as it was found on exit (PyTorch's default, True, runs them
    in TF32 on the card: about three decimal digits). Any other dtype leaves
    the flag untouched. The encoders wrap their convolutions in it, so that
    f32 compute means f32 whoever calls them."""
    if dtype != torch.float32:
        yield
        return
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was
