"""fused_waves_per_solve: the wave compiler's certified waves
(`CudaDevice.info()["fuse"]["fused_waves"]`) over the window, per solve.
Read only in cells whose path fuses."""


def read(run):
    return run.per_solve("fuse.fused_waves")
