"""Host milliseconds of the engine's decode lane per decode step (the
graph replay, the pick, the cost-tape feedback and the bookkeeping): the
window's total over its decode steps."""


def read(view):
    steps = [it for it in view.decode_steps() if "decode_s" in it.parts]
    if not steps:
        return None
    return 1e3 * sum(it.parts["decode_s"] for it in steps) / len(steps)
