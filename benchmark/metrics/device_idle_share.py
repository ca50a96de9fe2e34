"""The share of the run's time, in %, in which no device event ran: one
minus the device's busy time an NFE in the traced slice (the union of its
intervals over the slice's NFEs) over the wall time an NFE outside it
(the traced run's untraced NFEs, each ended by a synchronise). The trace
(CUDA activity alone) costs the host some microseconds a launch, so the
slice runs slower than the window and its own idle share, which the
device's busy_s and window_s give, reads higher; the busy time an NFE is
the device's alone. Nothing without a trace or untraced NFEs."""


def read(run):
    t, rest = run.trace, run.nfe_seconds
    if t is None or not run.traced_nfes or len(rest) < 2:
        return None
    busy = t.busy_s() / run.traced_nfes
    return 100.0 * (1.0 - busy / (sum(rest) / len(rest)))
