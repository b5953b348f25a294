"""rows_per_round (rows/round; layer: batcher, serving/batcher.py): the mean
number of requests a round served (the length of Engine.step's return)
over the window's rounds."""


def read(run):
    rounds = run.window_rounds()
    return sum(r for _, _, r in rounds) / len(rounds) if rounds else None
