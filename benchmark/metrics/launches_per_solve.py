"""launches_per_solve: the device manager's chore calls
(`CudaDevice.launches`, one per kernel call of a wave, a chained level or
an epilogue) over the window, per solve."""


def read(run):
    return run.per_solve("launches")
