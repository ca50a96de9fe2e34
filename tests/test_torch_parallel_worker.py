"""The rank program of tests/test_torch_parallel_ranks.py (it holds no
test). Each rank joins the gloo group from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), runs every data-parallel path of
the port on the inputs the test wrote into DIR, and saves what it got to
DIR/rank{r}.pt for the test to compare:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/test_torch_parallel_worker.py DIR
"""

import os
import sys
import traceback

import numpy as np
import torch

import kdip_tpu_torch as P
from kdip_tpu_torch.cli import evaluate as tevaluate
from kdip_tpu_torch.cli import sample_condition as tcli
from kdip_tpu_torch.parallel import dist as pdist
from kdip_tpu_torch.parallel import sharding


def sampler_case(inp, case):
    """The port's batched sampler for one of the test's modes."""
    c = inp["sampler"][case]
    unet = P.adm.ADMUNet(**inp["unet"], device="cpu")
    model = P.adm.ADMUNetV2(unet) if c["v2"] else unet
    model.load_state_dict(c["state_dict"])
    model.eval().requires_grad_(False)
    op = P.operators.get_operator(seed=1, device="cpu", **inp["op_cfg"])
    return P.sampling_api.build_posterior_sampler(
        model, P.diffusion.make_diffusion(1000, "linear", device="cpu"), op,
        P.guidance.GuidanceConfig(**c["gcfg"]),
        P.sampling_api.SamplerConfig(**inp["scfg"]), v2=c["v2"],
        image_size=inp["size"], device="cpu")


def run_sampler(inp, case, **kw):
    """(this rank's block, info) of the sharded sampler, the draws
    injected as the test's global ones (or, for a case without them, made
    by a generator seeded with gen_seed) unless kw says otherwise."""
    c = inp["sampler"][case]
    sharded = sharding.make_sharded_sampler(sampler_case(inp, case),
                                            torch.distributed.group.WORLD)
    draws = (dict(init_noise=c["init"], noise_fn=c["churn"].__getitem__)
             if "init" in c else
             dict(generator=torch.Generator().manual_seed(inp["gen_seed"])))
    draws.update(kw)
    return sharded(P.operators.Measurement(y=c["y"]), c["y"].shape[0],
                   return_info=True, **draws)


def train_loop(inp, mesh, dropout):
    t = inp["loop"]
    model = P.adm.ADMUNet(**dict(t["unet"], dropout=dropout), device="cpu")
    model.load_state_dict(t["state_dict"])
    noise = t["noise"]
    per_step = t["B"] // t["MB"]
    loop = P.train_loop.TrainLoop(
        model=model, tables=P.diffusion.make_diffusion(1000, "linear",
                                                        device="cpu"),
        data=iter(t["batches"]), batch_size=t["B"], microbatch=t["MB"],
        lr=t["lr"], ema_rate=t["ema"], log_interval=1, save_interval=100,
        logdir=f"{t['logdir']}_{dropout}", resume=False, seed=t["seed"],
        measure_gns=True,
        schedule_sampler=P.resample.LossSecondMomentResampler(1000),
        loss_type="rescaled_mse", mesh=mesh,
        noise_fn=lambda step, i: noise[step * per_step + i])
    # rank 0 writes the logs (the loop dumps them there alone)
    with P.logger.scoped_configure(
            dir=t["logdir"] + "/log",
            format_strs=["json"] if loop.rank == 0 else []):
        loop.run_loop(max_steps=t["steps"])
    return {"params": {k: v.clone() for k, v in model.state_dict().items()},
            "emas": [e.state_dict() for e in loop.ema_models],
            "counts": loop.schedule_sampler._loss_counts.copy()}


def train_step(inp):
    """One data-parallel train_openai step (`train.make_train_step` under
    the group) on the test's global batch and draws."""
    t = inp["step"]
    model = P.adm.ADMUNetV2(P.adm.ADMUNet(**t["unet"], device="cpu"))
    model.load_state_dict(t["state_dict"])
    tlog = P.diffusion.make_diffusion(1000, "linear", device="cpu").log_sigmas
    state = P.train.TrainState(model, t["lr"])
    step = P.train.make_train_step(
        lambda x, noise, sigma: P.train.openai_v2_loss(
            model, x, noise, sigma, tlog, P.transforms.OrthoTransform("dwt")),
        None, group=torch.distributed.group.WORLD)
    loss = step(state, t["x0"], t["decay"], sigma=t["sigma"],
                noise=t["noise"])
    return {"loss": float(loss), "params": model.state_dict(),
            "ema": state.ema.state_dict()}


def fsdp(inp, rank):
    """FSDP2 over a ("fsdp",) mesh against a replicated copy: the loss of
    the global batch and every parameter's gradient."""
    t = inp["fsdp"]
    ref = P.adm.ADMUNet(**t["unet"], device="cpu")
    ref.load_state_dict(t["state_dict"])
    model = P.adm.ADMUNet(**t["unet"], device="cpu")
    model.load_state_dict(t["state_dict"])
    mesh = sharding.make_mesh(axis_names=("fsdp",))
    sharding.shard_params_fsdp(model, mesh)
    x, tt = t["x"], t["t"]
    ref_loss = ref(x, tt).square().mean()
    ref_loss.backward()
    world = torch.distributed.group.WORLD
    local = model(sharding.shard_batch(x, world),
                  sharding.shard_batch(tt, world))
    loss = local.square().mean()
    loss.backward()
    placements = {n: p.placements[0].dim for n, p in model.named_parameters()}
    return {"loss": float(sharding.gather_to_host(loss.detach()[None],
                                                  world).mean()),
            "ref_loss": float(ref_loss),
            "grads": {n: p.grad.full_tensor() for n, p in
                      model.named_parameters()},
            "ref_grads": {n: p.grad for n, p in ref.named_parameters()},
            "placements": placements,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def main(d):
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    assert pdist.setup_dist(device="cpu")
    pdist.warmup_collectives()
    world = torch.distributed.group.WORLD
    rank = pdist.get_rank(world)
    out = {"world": pdist.get_world_size(world)}
    # the rank-0 byte broadcast: rank 1 reads nothing from storage
    path = inp["v1_path"] if rank == 0 else os.path.join(d, "missing.pt")
    out["broadcast"] = pdist.load_state_dict(path, group=world)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1)
        lin.bias.fill_(-rank)
    out["sync"] = pdist.sync_params(lin, world).state_dict()
    pdist.barrier("after_sync")
    for case in inp["sampler"]:
        out[case] = run_sampler(inp, case)
    gen = torch.Generator().manual_seed(inp["gen_seed"])
    out["generator"] = run_sampler(inp, "pgdm", generator=gen,
                                   init_noise=None, noise_fn=None)
    out["gns"] = [float(v) for v in P.gns.grad_norm_stats(
        [torch.as_tensor(g) for g in inp["gns"][rank]], world)]
    out["gns_local"] = [float(v) for v in P.gns.grad_norm_stats(
        [torch.as_tensor(g) for g in inp["gns"][rank]])]
    rs = P.resample.LossSecondMomentResampler(20, history_per_term=2)
    for ts, losses in inp["resample"][rank]:
        rs.update_with_local_losses(ts, losses, world)
    out["resample"] = (rs.weights(), rs._loss_history.copy())
    mesh = sharding.make_mesh()
    out["loop"] = train_loop(inp, mesh, 0.0)
    out["loop_dropout"] = train_loop(inp, mesh, inp["loop"]["dropout"])
    out["step"] = train_step(inp)
    out["fsdp"] = fsdp(inp, rank)
    tevaluate.PIXELS_SIZE = inp["eval"]["pixels_size"]
    out["decoded"] = []

    class Recorded(tevaluate.FolderOfImages):
        def __getitem__(self, idx):
            out["decoded"].append((self.root.name, idx))
            return super().__getitem__(idx)
    tevaluate.FolderOfImages = Recorded
    out["evaluate"] = tevaluate.main(inp["eval"]["argv"] + ["--dp"])
    out["cli"] = tcli.main(inp["cli"]["argv"] + ["--dp"])
    out["cli_files"] = sorted(os.listdir(inp["cli"]["logdir"]))
    try:
        tcli.main(inp["cli"]["argv_odd"] + ["--dp"])
    except SystemExit as e:
        out["odd_batch"] = str(e)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
