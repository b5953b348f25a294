"""itl_p95_ms (ms; layer: engine, serving/engine.py; host clock): the 95th
percentile, by nearest rank, of the gaps between tokens: each output a request streams
inside the window after its first, carrying k tokens after a gap g since
its previous output, gives k samples of g / k.  Above capacity its tail
is the rounds that carry a prefill, so it swings with which prompts the
window admits: a per-layer reading there, beside tokens_per_s."""
from benchkit.readings import nearest_rank


def read(run):
    samples = run.itl_samples()
    return 1e3 * nearest_rank(samples, 95) if samples else None
