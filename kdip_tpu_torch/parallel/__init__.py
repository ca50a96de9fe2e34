"""Scale-out over torch.distributed ranks (PyTorch port of
`kdip_tpu/parallel/`): `dist`, the process group and the rank-0
checkpoint broadcast; `sharding`, the batch blocks, FSDP2 and the sharded
sampler."""

from . import dist, sharding  # noqa: F401
