"""Host milliseconds of the decode lane's cost-tape feedback and offset
refresh (``kernels/compiled.py`` ``CompiledDispatcher.feedback`` through the
engine's ``_feedback``) per decode step: the window's total over its decode
steps."""


def read(view):
    steps = [it for it in view.decode_steps() if "feedback_decode_s" in it.parts]
    if not steps:
        return None
    return 1e3 * sum(it.parts["feedback_decode_s"] for it in steps) / len(steps)
