"""The 95th percentile of one guided NFE's wall time, in ms, over the
untraced NFEs of a traced run (the Clock synchronises at every NFE
boundary there); nothing with fewer than 20 NFEs."""

import numpy as np


def read(run):
    s = run.nfe_seconds
    if len(s) < 20:
        return None
    return float(np.percentile(np.asarray(s) * 1e3, 95))
