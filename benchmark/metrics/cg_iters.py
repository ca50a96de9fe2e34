"""The CG iterations of the window's first solve, as the program's sampler
reports them (info["cg_total_iters"]); nothing where that solve did not
finish in the window."""


def read(run):
    return run.cg_iters_first_solve
