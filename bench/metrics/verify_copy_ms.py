"""verify_copy_ms (ms/round; layer: engine, serving/engine.py
``Engine._to_host``): the device time of the copies launched inside the
program's ``host.copy.verify`` ranges (the verify logits' device-to-host
copy) that start in the traced segment, over the segment's rounds.  None
where the segment holds no such range, or the trace holds no runtime calls
(no CUDA device)."""
from benchkit import ranges


def read(run):
    if not run.traced or not ranges.has_device_records(run.hooks.trace):
        return None
    rs = ranges.find(run.hooks.trace, (ranges.COPY_VERIFY,))
    n = run.traced_rounds()
    if not rs or not n:
        return None
    return 1e-3 * sum(b - a for r in rs for a, b, cat in r.ops if cat == "gpu_memcpy") / n
