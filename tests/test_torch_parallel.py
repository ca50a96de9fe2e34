"""The port's scale-out helpers (`kdip_tpu_torch.parallel`) in one process:
`fsdp_spec` against `kdip_tpu`'s, `setup_dist`'s launcher detection and
its refusal of a silent multi-worker degrade, `dev`'s refusal of a rank
without a card, the rank-0 checkpoint read, `sync_params` and the batch
helpers without a group and in a group of one gloo rank. The two-rank
paths are tests/test_torch_parallel_ranks.py."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from kdip_tpu.parallel import sharding as jsh
from kdip_tpu_torch import gns, guidance
from kdip_tpu_torch.parallel import dist as pdist
from kdip_tpu_torch.parallel import sharding
from test_torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MARKERS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
           "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
           "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_JOB_ID", "SLURM_NTASKS",
           "SLURM_PROCID", "SLURM_LOCALID")


@pytest.fixture
def no_markers(monkeypatch):
    for name in MARKERS:
        monkeypatch.delenv(name, raising=False)
    assert not tdist.is_initialized()
    return monkeypatch


@pytest.fixture
def group_of_one(no_markers):
    """A gloo process group of one rank in this process, torn down
    after."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert pdist.setup_dist(init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0, device="cpu")
    yield
    tdist.destroy_process_group()


@pytest.mark.parametrize("shape,size", [
    ((3, 3, 32, 64), 4), ((5,), 4), ((64, 32, 3, 3), 2), ((6, 6), 3),
    ((7, 9), 2), ((), 2), ((128, 256, 3, 3), 8), ((12, 12, 12), 4)])
def test_fsdp_spec_matches_kdip_tpu(shape, size):
    """The dimension fsdp_spec shards (the largest that the axis size
    divides, the first of equal ones; replicated if none does) is
    kdip_tpu's, entry for entry."""
    want = tuple(jsh.fsdp_spec(np.zeros(shape), size))
    assert sharding.fsdp_spec(torch.empty(shape), size) == want


def test_setup_dist_is_a_noop_without_markers(no_markers):
    """No launcher marker, no arguments: one process, no group, and every
    helper is local (rank 0 of 1, barrier and warm-up do nothing)."""
    assert pdist.setup_dist() is False
    assert not tdist.is_initialized()
    assert (pdist.get_rank(), pdist.get_world_size()) == (0, 1)
    pdist.barrier("nothing")
    pdist.warmup_collectives()


@pytest.mark.parametrize("markers", [
    {"SLURM_JOB_ID": "123", "SLURM_NTASKS": "4"},
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"},
    {"WORLD_SIZE": "2", "RANK": "0"}], ids=["slurm", "openmpi", "torchrun"])
def test_setup_dist_refuses_silent_multiworker_degrade(no_markers, markers):
    """Markers that announce more than one process but no rendezvous
    address (MASTER_ADDR / MASTER_PORT) raise instead of running each
    process alone (kdip_tpu's test_setup_dist_refuses_silent_multiworker_
    degrade); the ambiguous single-task Slurm case goes on in one
    process."""
    for k, v in markers.items():
        no_markers.setenv(k, v)
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        pdist.setup_dist(device="cpu")
    assert not tdist.is_initialized()
    if "SLURM_NTASKS" in markers:
        no_markers.setenv("SLURM_NTASKS", "1")
        assert pdist.setup_dist(device="cpu") is False


@pytest.mark.parametrize("local_rank,cards", [("0", 0), ("1", 1)])
def test_dev_refuses_a_rank_without_a_card(no_markers, local_rank, cards):
    """dev() is cuda:LOCAL_RANK or an exit with a message, never the CPU:
    no card at all, or LOCAL_RANK 1 on a machine with one card; and
    setup_dist on the card path refuses before it joins a group."""
    no_markers.setenv("LOCAL_RANK", local_rank)
    no_markers.setattr(torch.cuda, "is_available", lambda: cards > 0)
    no_markers.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=f"LOCAL_RANK {local_rank} has no "
                                         "CUDA card"):
        pdist.dev()
    with pytest.raises(SystemExit, match="no CUDA card"):
        pdist.setup_dist(init_method="tcp://localhost:1", world_size=1,
                         rank=0, device="cuda")
    assert not tdist.is_initialized()


def _state(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.tensor([1, 2])}
    path = str(tmp_path / "m.pt")
    torch.save(sd, path)
    np.savez(str(tmp_path / "m.npz"), a=np.arange(4))
    return sd, path


def test_load_state_dict_and_sync_params_without_a_group(no_markers,
                                                         tmp_path):
    """Without a group load_state_dict is a local read (.pt through the
    checkpoint reader, .npz through numpy, `parse` and `convert`
    honoured, an orbax directory refused) and sync_params the identity."""
    sd, path = _state(tmp_path)
    got = pdist.load_state_dict(path)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    npz = pdist.load_state_dict(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(npz["a"], np.arange(4))
    assert pdist.load_state_dict(path, parse=lambda f: f.read(4)) == open(
        path, "rb").read(4)
    assert pdist.load_state_dict(path, convert=lambda p: p) == path
    with pytest.raises(SystemExit, match="orbax"):
        pdist.load_state_dict(str(tmp_path))
    lin = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    assert pdist.sync_params(lin) is lin
    assert all(torch.equal(before[k], v) for k, v in
               lin.state_dict().items())


def test_helpers_in_a_group_of_one(group_of_one, tmp_path):
    """In a one-rank gloo group the byte broadcast, sync_params, the
    barrier and warm-up, the batch helpers and grad_norm_stats run their
    collectives and give the one process's values; a missing file raises
    on every rank."""
    world = torch.distributed.group.WORLD
    sd, path = _state(tmp_path)
    got = pdist.load_state_dict(path, group=world)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(SystemExit, match="No such file"):
        pdist.load_state_dict(str(tmp_path / "missing.pt"), group=world)
    assert pdist.read_if_present(str(tmp_path / "missing.pt"),
                                 torch.load, world) is None
    assert pdist.broadcast_object({"a": [1, 2]}, world) == {"a": [1, 2]}
    lin = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    pdist.sync_params(lin, world)
    assert all(torch.equal(before[k], v) for k, v in
               lin.state_dict().items())
    pdist.warmup_collectives()
    pdist.barrier("twice")
    pdist.barrier("twice")
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(sharding.shard_batch(x, world), x)
    np.testing.assert_array_equal(sharding.gather_to_host(x, world), x.numpy())
    parts = sharding.all_gather_blocks(x[:3], world)
    assert len(parts) == 1 and torch.equal(parts[0], x[:3])
    grads = [torch.ones(2, 2), torch.full((3,), 2.0)]
    small, big = gns.grad_norm_stats(grads, world)
    assert float(small) == float(big) == 16.0
    mesh = sharding.make_mesh()
    assert sharding.group_of(mesh) is not None
    with pytest.raises(ValueError, match="every rank"):
        sharding.make_mesh(2)
    hybrid = sharding.make_hybrid_mesh(1)
    assert hybrid.mesh_dim_names == ("dcn", "dp") and hybrid.ndim == 2
    assert sharding.group_of(hybrid, "dp") is not None
    assert [type(p).__name__ for p in sharding.batch_sharding()
            + sharding.replicated()] == ["Shard", "Replicate"]
    assert sharding.batch_sharding()[0].dim == 0


def test_block_and_data_parallel_without_a_group(no_markers):
    """block cuts rank r's rows and refuses a batch the ranks do not
    divide; data_parallel hands fn the whole batch in one process."""
    x = torch.arange(8.0)
    assert torch.equal(sharding.block(x, 1, 4), torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        sharding.block(x, 0, 3)
    p, b = sharding.data_parallel(lambda p, b: (p, b))("params", x)
    assert p == "params" and torch.equal(b, x)
    with pytest.raises(SystemExit, match="process group"):
        sharding.group_of(object())


def test_batch_reductions_are_local_without_a_group():
    """guidance's reductions over the batch without a batch group are the
    plain local ones, bit for bit (the one-process path is unchanged)."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 4, generator=g), torch.randn(3, 4, generator=g)
    assert guidance._BATCH_GROUP is None
    assert torch.equal(guidance._vdot(a, b), torch.dot(a.reshape(-1),
                                                       b.reshape(-1)))
    assert torch.equal(guidance._batch_mean(a), a.mean())
    assert torch.equal(guidance._batch_norm(a), torch.linalg.vector_norm(a))
    assert guidance._batch_numel(a) == 12
