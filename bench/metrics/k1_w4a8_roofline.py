"""k1_w4a8_roofline (%; layer: kernels/w4a8_matmul.py): the sum over the
traced segment's K1 calls of the least time each could take (the larger
of its operations over the int8 peak, 1,979 TOP/s, and its bytes over
3.35 TB/s; roofline/counts.py at each call's shapes), over the summed
device time of the w4a8_mma_kernel launches in the profiler's trace."""
from benchkit.readings import share
from benchkit.trace import kernel_seconds
from roofline import counts


def read(run):
    if not run.traced:
        return None
    bound = sum(counts.lower_bound_s(counts.k1_ops(m, k, n), counts.k1_bytes(m, k, n),
                                     counts.PEAKS["int8_ops"]) for m, k, n in run.hooks.k1)
    return share(bound, kernel_seconds(run.summary, "w4a8_mma_kernel"))
