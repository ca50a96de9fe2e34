"""The Winograd kernels' share of their roofline, in %: for each launch of
an NFE (`work.winograd_launches`, from the architecture at the cell's
batch) the least time the card could take for the direct 3x3 conv it
computes, the larger of its FLOPs at the bfloat16 peak and its bytes at
the HBM bandwidth (`work.direct_conv_work`), summed over the traced NFEs,
over the device time of the `winograd_f23` kernels in the trace. Nothing
where the trace holds no such kernel."""

from harness import work


def read(run):
    if run.trace is None or not run.peaks:
        return None
    device_s = run.trace.kernel_seconds("winograd_f23")
    if device_s <= 0:
        return None
    p = run.peaks
    bound = 0.0
    for key, n in work.winograd_launches(run.model_meta(), run.batch,
                                         run.image_size).items():
        flops, nbytes = work.direct_conv_work(*key)
        bound += n * max(flops / p["bf16_flops_per_s"],
                         nbytes / p["hbm_bytes_per_s"])
    return 100.0 * bound * run.traced_nfes / device_s
