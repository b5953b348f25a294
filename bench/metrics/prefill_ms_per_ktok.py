"""prefill_ms_per_ktok (ms/ktok; layer: engine, serving/engine.py
``Engine._admit`` / ``_prefill_into``): the program's
``engine.prefill.target`` and ``engine.prefill.draft`` ranges that start
in the traced segment (benchkit/ranges.py), each from its start to the
later of its end and the end of the last device operation it launched,
summed, per 1,000 prompt rows of the target's ranges (the rows each
range carries).  None where the segment admitted no request."""
from benchkit import ranges


def read(run):
    if not run.traced:
        return None
    rs = ranges.find(run.hooks.trace, ranges.PREFILLS)
    rows = ranges.prefill_rows(rs)
    if not rows:
        return None
    return sum(r.end - r.t0 for r in rs) / rows  # us per row = ms per 1,000 rows
