"""Parameter construction for the port's models.

``Init`` plays the reference's ``Builder`` (``repro.common.params``): each
dense tensor is a normal draw times ``scale / sqrt(fan_in)``, made in fp32
and cast to the model dtype. Draws come from one ``torch.Generator`` on the
target device, one tensor at a time, so building a model never holds more
than one fp32 copy of its largest matrix (phi4-mini's 200,064 × 3,072
embedding: 2.5 GB) beside the finished parameters. The draws differ from
``jax.random``'s for the same seed: parity with the reference goes through
``convert.lm_params_from_jax``. Parameters are plain dicts of tensors;
their logical axes, which only the dry run reads, are built beside them
by ``launch.dryrun.param_axes``.

On the meta device (the dry run's traces) there is no generator
(``torch.Generator`` takes no meta device): ``dense``, ``zeros`` and
``ones`` return ``torch.empty`` of the shape and dtype, which hold no
data.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device`` as given, or the CUDA device when it is None: the port's
    entry points run on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; pass "
                "device='cpu' to run the plain versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" names the current device: pin it, so it compares equal to
        # the device of the tensors made on it
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class Init:
    """Seeded parameter initialiser on one device."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.meta = self.device.type == "meta"
        self.generator = None if self.meta else torch.Generator(
            device=self.device).manual_seed(int(seed))

    def dense(self, shape: Tuple[int, ...], fan_in: Optional[int] = None,
              scale: float = 1.0,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A normal draw times ``scale / sqrt(fan_in)``, in ``dtype`` (None =
        the model dtype; the MoE router is fp32 whatever the model's)."""
        if self.meta:
            return torch.empty(shape, dtype=dtype or self.dtype,
                               device=self.device)
        fi = fan_in if fan_in is not None else shape[0]
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        w.mul_(scale / math.sqrt(max(fi, 1)))
        return w.to(dtype or self.dtype)

    def zeros(self, shape: Tuple[int, ...]) -> torch.Tensor:
        fill = torch.empty if self.meta else torch.zeros
        return fill(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape: Tuple[int, ...]) -> torch.Tensor:
        fill = torch.empty if self.meta else torch.ones
        return fill(shape, dtype=self.dtype, device=self.device)
