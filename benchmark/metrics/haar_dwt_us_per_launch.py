"""The Haar DWT kernel's mean device time a launch, in us: the device time
of the `haar_dwt2` kernels in the traced slice over their launches (in the
DWT-Var cells nearly all of them the fused CG matvec). A time and not a
share of a roofline: at these sizes the matvec's working set (v, theta,
the mask, y: about 20 MB at 8 images) fits in the card's 50 MB L2, so a
count of its bytes at the HBM bandwidth would bound nothing. Nothing where
the trace holds no such kernel."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.kernel_launches("haar_dwt2")
    if n == 0:
        return None
    return 1e6 * run.trace.kernel_seconds("haar_dwt2") / n
