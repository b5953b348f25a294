"""prefill_launches_per_ktok (launches/ktok; layer: model forward,
models/lm.py, models/layers.py, serving/quantized_lm.py): kernel launch
API calls (``trace.LAUNCH_APIS``) inside the program's
``engine.prefill.*`` ranges that start in the traced segment, per 1,000
prompt rows of the target's ranges.  None where the segment admitted no
request, or the trace holds no runtime calls (no CUDA device)."""
from benchkit import ranges


def read(run):
    if not run.traced or not ranges.has_device_records(run.hooks.trace):
        return None
    rs = ranges.find(run.hooks.trace, ranges.PREFILLS)
    rows = ranges.prefill_rows(rs)
    if not rows:
        return None
    return 1000.0 * sum(r.launches for r in rs) / rows
