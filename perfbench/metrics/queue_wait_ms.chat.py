"""Milliseconds from a request's due time to the start of the iteration
that runs its first prefill chunk (the scheduler's admission queue),
mean over the requests due in the window."""


def read(view):
    waits = [r.first_chunk - (view.origin + r.due)
             for r in view.due_in_window() if r.first_chunk is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None
