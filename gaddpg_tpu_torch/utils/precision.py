"""Matmul precision and device selection.

The JAX package pins geometry matmuls to float32 because reduced
precision there collapsed expert success from ~0.8 to ~0.2. On the card
the reduced-precision trap is TF32: float32 convolutions go through
cuDNN in TF32 by default, and matmuls do whenever `allow_tf32` is set.
`f32_matmuls` turns both off around the wrapped call. It also keeps the
partial sums of bfloat16 matmuls in float32 (cuBLAS may reduce them in
bfloat16 otherwise), as the JAX package's bfloat16 products accumulate.
"""

import functools

import torch


def f32_matmuls(fn):
    """Run `fn` with TF32 off for cuBLAS matmuls and cuDNN convolutions
    and cuBLAS' reduced-precision reduction of bfloat16 matmuls off,
    restoring the caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        prev = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                matmul.allow_bf16_reduced_precision_reduction)
        matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            return fn(*args, **kwargs)
        finally:
            (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction) = prev

    return wrapped


def resolve_device(device) -> torch.device:
    """`device` as a torch.device with an explicit index for CUDA ("cuda"
    becomes the current card, as tensors placed there report it); raises
    if it names CUDA and no card is present, instead of quietly running
    on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
