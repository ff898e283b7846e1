"""Device choice for the port's entry points: the card, unless told otherwise.

Every entry point (:class:`repro_torch.core.TriangleCounter`, the CLI)
runs on ``cuda`` by default and raises when no card is visible.  The CPU
is used only when the caller asks for it — the tests do — so a run never
lands on the host without saying so.  ``meta`` (shapes without memory, the
dry run's device: :mod:`repro_torch.launch.dryrun`) likewise only when named.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means ``cuda``.  A bare
    ``cuda`` becomes the current card (``cuda:0`` …), the device its
    tensors report, so a counter compares equal with the data it made.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda', 'cpu' or 'meta'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
