"""accept_rate (ratio; layer: engine, serving/engine.py): draft tokens
accepted over draft tokens proposed in the window, from the engine's
registry counters tokens_accepted_total / tokens_drafted_total."""


def read(run):
    drafted = run.counter_delta("tokens_drafted_total")
    return run.counter_delta("tokens_accepted_total") / drafted if drafted else None
