"""The share of the traced window in which no kernel, copy or memset ran
on the card, in %; with several cards the idlest card's."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * max(run.trace.idle_share(c) for c in run.cards)
