"""The whole guided step's share of the card's dense bfloat16 peak, in %:
the model FLOPs of one NFE at the cell's batch (UNet forward and its vjp
with respect to x, counted from the architecture's shapes by
`work.unet_flops`, whatever implements a conv) times the untraced NFEs of
a traced run, over their wall time. Nothing for a card without a peak on
record."""

from harness import work


def read(run):
    if not run.peaks or len(run.nfe_seconds) < 2:
        return None
    flops = work.unet_flops(run.model_meta(), run.batch,
                            run.image_size)["total"]
    rate = flops * len(run.nfe_seconds) / sum(run.nfe_seconds)
    return 100.0 * rate / run.peaks["bf16_flops_per_s"]
