"""Device set-up for runs on the card."""

from __future__ import annotations

import torch

__all__ = ["require_cuda"]


def require_cuda() -> torch.device:
    """Return the first CUDA device, or raise when there is none.

    Also turns TF32 off for f32 matrix products and convolutions: a float32
    reference on the card must run in full float32 (cuDNN's f32 convolutions
    use TF32 unless told otherwise). bf16 work is not affected."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
