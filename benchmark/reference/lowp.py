"""The control's lower precision: float8 e4m3 with one scale a tensor.

The program's configurations state a bfloat16 torso (float32 GroupNorm
statistics and sampler state). The precision below bfloat16 that would
tempt a later change is float8, as its matrix units run it: every operand
of a conv, linear or attention product is scaled so that its largest
magnitude lands on e4m3's largest finite value (448), rounded to e4m3 and
scaled back; the product itself then runs in float32. `adm.build(cfg,
q=fp8)` is the reference computed so, which must fail the comparison.
"""

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
