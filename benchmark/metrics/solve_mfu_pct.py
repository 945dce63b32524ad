"""solve_mfu_pct: the useful flops of the window's solves over the traced
window (host clock) times the card's float32 peak: the whole solve's
share of the chip, which bounds every kernel's roofline share."""


def read(run):
    if not run.peak_flops or not run.n_solves:
        return None
    return (100.0 * run.flops_per_solve * run.n_solves
            / (run.window_s * run.peak_flops))
