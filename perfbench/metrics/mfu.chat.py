"""The whole step's share of the card's peak: the least time the window's
work needs (each iteration's bytes over HBM or operations over the
bfloat16 peak, whichever is longer; ``harness/work.py``) over the window.
Percent."""


def read(view):
    return view.mfu_percent()
