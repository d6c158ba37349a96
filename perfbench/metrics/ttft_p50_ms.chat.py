"""Milliseconds from a request's due time to its first token on the wall
clock, the median over every request due in the window (one that never got
a token counts as infinitely late): the one prefill lane's time for a
prompt plus the wait behind the prompts before it."""

from perfbench.harness import endtoend


def read(view):
    tt = endtoend.ttfts(view.requests, view.origin, view.seconds)
    return 1e3 * endtoend.percentile(tt, 50) if tt else None
