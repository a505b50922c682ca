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


def on_card(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device, False when all lie
    on the CPU. Mixed placements are a caller error."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {'cuda'}:
        return True
    if kinds == {'cpu'}:
        return False
    raise ValueError(f'tensors on mixed or unsupported devices: {kinds}')
