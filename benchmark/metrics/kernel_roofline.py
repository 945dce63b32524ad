"""kernel_roofline: the least time the useful flops of the window's
solves need at the card's float32 peak (67 TFLOP/s on the H100 SXM: the
chores run IEEE float32 products, TF32 off), over the summed time of the
device kernels in the traced window.

At NB 512 every chore's arithmetic intensity (a 512 x 512 x 512 product:
~85 flops a byte of float32 operands) lies far right of the card's ridge
point (67e12 / 3.35e12 = 20 flops a byte), so the bound is the compute
one.  Kernels that do no useful flop (copies, gathers, masks) and flops
the path does beyond the operation's count (the panel DAG's full-height
products) lower the share."""


def read(run):
    kernels = run.window_ops(("kernel",))
    if not kernels or not run.peak_flops or not run.n_solves:
        return None
    busy = sum(b - a for a, b in kernels) / 1e9
    need = run.flops_per_solve * run.n_solves / run.peak_flops
    return 100.0 * need / busy
