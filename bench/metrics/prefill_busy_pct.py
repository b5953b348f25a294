"""prefill_busy_pct (%; layer: device): the union of the device
operations that the program's ``engine.prefill.*`` ranges launched, over
the union of those ranges' walls, each from its start to the later of its
end and the end of its last device operation.  None where the segment
admitted no request, or the trace holds no runtime calls (no CUDA
device)."""
from benchkit import ranges
from benchkit.trace import _union


def read(run):
    if not run.traced or not ranges.has_device_records(run.hooks.trace):
        return None
    rs = ranges.find(run.hooks.trace, ranges.PREFILLS)
    if not rs:
        return None
    wall = _union([(r.t0, r.end) for r in rs])
    return 100.0 * ranges.busy_us(rs) / wall if wall > 0 else None
