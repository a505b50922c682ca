"""Device selection and kernel dispatch.

Entry points run on the card unless the caller asks for the CPU. A kernel
wrapper launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when no CUDA device is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" to run the plain PyTorch '
                'versions of the kernels on the CPU')
        return torch.device('cuda')
    return torch.device(device)


def full_f32():
    """No TF32 in cuDNN's convolutions or cuBLAS's products, for the whole
    process. Set once where a run is configured (``build_detector`` of a
    config with a camera branch), so that every step of the run, forward
    and backward, computes alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def on_card(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device, False when all lie
    on the CPU. Mixed placements are a caller error."""
    # is_cuda first: a wrapper pays this on every call, and it makes no
    # device object
    kinds = {'cuda' if t.is_cuda else t.device.type
             for t in tensors if t is not None}
    if kinds == {'cuda'}:
        return True
    if kinds == {'cpu'}:
        return False
    raise ValueError(f'tensors on mixed or unsupported devices: {kinds}')


def as_kernel_arg(t, dtype):
    """``t`` as a contiguous ``dtype`` tensor: itself when it is one (no
    dispatch, which a wrapper pays per argument on every call), else a
    copy."""
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    return t.to(dtype).contiguous()
