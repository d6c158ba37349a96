"""Live rows over the engine's slots, averaged over the window's decode
steps (the scheduler's and the slot manager's work: ``serving/scheduler.py``,
``serving/slots.py``).  Percent."""


def read(view):
    steps = view.decode_steps()
    if not steps:
        return None
    live = sum(len(it.decode_ctx) for it in steps) / len(steps)
    return 100.0 * live / view.slots
