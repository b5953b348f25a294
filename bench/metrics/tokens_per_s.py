"""tokens_per_s (tokens/s, higher is better; host clock): every output
token streamed inside the window, over the window's length."""


def read(run):
    return sum(k for _, _, k in run.window_emits()) / run.rec.window_s
