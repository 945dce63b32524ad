"""setup_s: process start to the first timed solve (host clock): the
program's import, the native core's build where it is missing, the
Context and CudaDevice, the inputs made on the card and one untimed
solve."""


def read(run):
    return run.setup_s
