"""cert_ms: the wave compiler's time having each pool's chain
certificates, from its cache of pool structures or from the certificate
pass (`CudaDevice.stats["cert_ns"]`, a part of `mgr_plan_ns`) over the
window, per solve.  `spotrf.dist4`: rank 0's counters only.  Nothing
where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.cert_ns")
    return None if ns is None else ns / 1e6
