"""train_tokens_per_s: the tokens of every step finished in the window
(the card synchronised at its end) over the window's length."""


def read(run):
    if run.cell.kind != "train":
        return None
    return run.steps * run.tokens_per_step / run.window_s
