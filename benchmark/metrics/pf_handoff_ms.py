"""pf_handoff_ms: the device manager's time inside the prefetch lane's
handoff() after its waves (`CudaDevice.stats["pf_handoff_ns"]`, a part
of `mgr_plan_ns`) over the window, per solve: near 0 where the lane
rests because every tile the lookahead reads is already on the card.
Nothing where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.pf_handoff_ns")
    return None if ns is None else ns / 1e6
