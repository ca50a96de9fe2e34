"""kdip_tpu_torch: the PyTorch/CUDA port of `kdip_tpu` for NVIDIA Hopper.

Module names mirror `kdip_tpu`'s. The package imports torch and numpy only,
never JAX or `kdip_tpu`; layout is NCHW. Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`. Hand-written
CUDA kernels live under `csrc/` and are built with nvcc at first use
(`ops/_build.py`).
"""

from . import (config, diffusion, guidance, operators, precond,  # noqa: F401
               samplers, sampling_api, schedules, weights)
from .models import adm, layers  # noqa: F401
from .ops import dwt, transforms, winograd  # noqa: F401
