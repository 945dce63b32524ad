"""tasks_per_solve: the device's task counter (`CudaDevice.stats
["tasks"]`: launched, completed from a parked result or an epilogue) over
the window, per solve."""


def read(run):
    return run.per_solve("stats.tasks")
