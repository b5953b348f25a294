"""launches_per_round (launches/round; layer: model forward,
serving/quantized_lm.py, models/lm.py, models/layers.py): kernel launch
API calls (cudaLaunchKernel, cuLaunchKernel, cudaLaunchKernelExC,
cuLaunchKernelEx, cudaGraphLaunch) in the traced segment's profiler trace,
over the rounds of the segment.  Where the trace carries no runtime API
records, the kernels it ran are counted instead, one per launch."""


def read(run):
    if not run.traced:
        return None
    n = run.traced_rounds()
    return run.summary["launches"] / n if n else None
