"""Device milliseconds of the captured decode step (``serving/step_graph.py``
``StepGraph`` replay with its input copies), by CUDA events around the
engine's ``_decode``, per decode step over the window."""


def read(view):
    return view.mean_part(view.decode_steps(), "body_ms")
