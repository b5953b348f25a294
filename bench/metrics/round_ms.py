"""round_ms (ms; layer: engine, serving/engine.py): the window's length over
the engine steps inside it that ran a round (had an active row)."""


def read(run):
    n = len(run.window_rounds())
    return 1e3 * run.rec.window_s / n if n else None
