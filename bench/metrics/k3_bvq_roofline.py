"""k3_bvq_roofline (%; layer: kernels/bvq_matmul.py): the sum over the
traced segment's K3 calls of the least time each could take (the larger
of its operations over the bf16 peak, 989 TFLOP/s, and its bytes over
3.35 TB/s; roofline/counts.py at each call's shapes), over the summed
device time of the bvq_mma_kernel launches in the profiler's trace."""
from benchkit.readings import share
from benchkit.trace import kernel_seconds
from roofline import counts


def read(run):
    if not run.traced:
        return None
    bound = sum(counts.lower_bound_s(counts.k3_ops(m, k, n),
                                     counts.k3_bytes(m, k, n, nb, c, v, xes, ies),
                                     counts.PEAKS["bf16_flops"])
                for m, k, n, nb, c, v, xes, ies in run.hooks.k3)
    return share(bound, kernel_seconds(run.summary, "bvq_mma_kernel"))
