"""Where the port runs, and its float32 posture.

Entry points take ``device=None``, which means the CUDA card. The CPU is used
only when a caller passes ``device="cpu"`` (the tests do); there is no
"cuda, else cpu" pick, so a missing card is an error, never a quiet switch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def set_fp32_posture() -> None:
    """Full float32 for every matrix product and convolution on the card.

    PyTorch already runs float32 matmuls in full precision by default, but
    cuDNN convolutions default to TF32 (about three decimal digits); the
    JAX reference is held to float32, so both switches are set here, once.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card unless "
                "the caller passes device='cpu'"
            )
        set_fp32_posture()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
