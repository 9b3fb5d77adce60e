"""sanm_tpu_torch: the PyTorch + CUDA port of ``sanm_tpu`` for one NVIDIA H100.

The package mirrors ``sanm_tpu``'s module names.  It imports ``torch``
and never ``jax`` or anything of ``sanm_tpu``: what it needs from the
JAX package's host-only modules is kept here as its own copy.

Device rule: every entry point takes ``device``.  ``None`` means the
CUDA card and raises when there is none; the CPU is used only when the
caller passes ``device="cpu"`` (as the tests do).  There is no
environment switch that changes the device.  All tensors are float64:
H100 f64 is native IEEE, so none of the TPU's emulated-f64 workarounds
are ported.
"""

from __future__ import annotations

import torch

from .utils import SANMError, SANMNumericalError, ScopedProfiler  # noqa: F401

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device``
    names the CPU.  Raises instead of falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise SANMError(
                "no CUDA device: sanm_tpu_torch runs on the card; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SANMError("device %r requested but CUDA is unavailable"
                            % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise SANMError("unsupported device %r" % str(device))
    return dev
