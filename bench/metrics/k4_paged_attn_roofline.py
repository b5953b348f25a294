"""k4_paged_attn_roofline (%; layer: kernels/paged_attn.py, the fp body):
the sum over the traced segment's paged-attention calls of the least time
each could take (the larger of its operations over the bf16 peak and its
bytes over 3.35 TB/s; the bytes read are the K/V of the positions each
row's window reads, roofline/counts.py), over the summed device time of
the paged_attn_kernel launches in the profiler's trace.  Read only where
every call of the segment ran the fp body (no int8 pools)."""
from benchkit.readings import attn_bound_s, share
from benchkit.trace import kernel_seconds


def read(run):
    if not run.traced or any(call[7] for call in run.hooks.attn):
        return None
    return share(attn_bound_s(run, int8=False), kernel_seconds(run.summary, "paged_attn_kernel"))
