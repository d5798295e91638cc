"""Device set-up for runs on the card."""

from __future__ import annotations

import functools

import torch

__all__ = ["require_cuda", "same_device", "device_constant", "host_to_device"]


def require_cuda() -> torch.device:
    """Return the current CUDA device (the first, unless the process was
    bound to another: `parallel.initialize_distributed` binds a rank to
    cuda:LOCAL_RANK), or raise when there is none.

    Also turns TF32 off for f32 matrix products and convolutions: a float32
    reference on the card must run in full float32 (cuDNN's f32 convolutions
    use TF32 unless told otherwise). bf16 work is not affected."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def same_device(a, b) -> bool:
    """Whether two devices are one (an index left out is 0)."""
    a, b = torch.device(a), torch.device(b)
    return (a.type, a.index or 0) == (b.type, b.index or 0)


@functools.lru_cache(maxsize=256)
def _constant(values, dtype, device) -> torch.Tensor:
    # outside inference mode, so that a tensor made during serving can take
    # part in a later training graph
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor (nested tuples of numbers) on `device`, copied
    there once and shared by every caller: never write to it. A fresh
    `torch.tensor(..., device="cuda")` per call is a copy from pageable host
    memory, which waits for all the work queued on the stream; a thread that
    prepares batches next to a training loop must not do that."""
    return _constant(values, dtype, torch.device(device))


def host_to_device(array, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on `device`; a tensor already
    there is returned as it is. For the card the copy goes through pinned
    memory and is asynchronous: a copy from pageable memory would hold the
    calling thread until all the work queued on the stream is done (a
    producer thread would stand behind the train step)."""
    device = torch.device(device)
    tensor = torch.as_tensor(array)
    if device.type != "cuda" or tensor.device.type != "cpu":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)
