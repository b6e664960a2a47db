"""The share of the traced scan (the window's second whole scan) in which
no kernel, copy or memset ran on the card, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * max(run.trace.idle_share(c) for c in run.cards)
