"""mfu (%; layer: device): the model FLOPs of the work the traced segment
completed, over the segment's length times the H100's dense bf16 peak,
989 TFLOP/s (roofline/counts.PEAKS).  The work: every paged forward (the
draft's steps and the target's verify) over its active rows and every
prefill, at 2 x the parameters of every linear per row plus 4 x hd per
(query head, visible key) per layer, counted from the config."""
from benchkit.readings import traced_model_flops
from roofline.counts import PEAKS


def read(run):
    if not run.traced:
        return None
    flops = traced_model_flops(run)
    return 100.0 * flops / (run.summary["window_s"] * PEAKS["bf16_flops"]) if flops else None
