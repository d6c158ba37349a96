"""Live rows over the engine's slots in the open loop, averaged over the
window's decode steps: how much of the captured decode batch the chat
traffic fills.  Percent."""


def read(view):
    steps = view.decode_steps()
    if not steps:
        return None
    live = sum(len(it.decode_ctx) for it in steps) / len(steps)
    return 100.0 * live / view.slots
