"""setup_s (s, lower is better; host clock): from the start of the
process to the opening of the window: imports, the kernels' build (the
first run in a checkout), the weights made and packed on the device, the
engine, the warm-up of every shape the mix uses, and the mix's start
state: its running requests admitted (prefilled), its queued ones added."""


def read(run):
    return run.setup_s
