"""grid_mfu_pct: the useful flops of the window's solves over the window
(host clock) times the four cards' float32 peak: the whole grid's share
of its chips.  The grid is the 2 x 2 of the cells that list this metric,
one rank a card; the peak is rank 0's card's (every card of the host is
of one kind).  `solve_mfu_pct` divides by one card's peak."""

CARDS = 4


def read(run):
    if not run.peak_flops or not run.n_solves:
        return None
    return (100.0 * run.flops_per_solve * run.n_solves
            / (run.window_s * CARDS * run.peak_flops))
