"""The Q4_0 kernels' share of their roofline over every iteration of the
profiled slice, prefill chunks and decode steps (see
``q4_roofline.decode``).  Percent."""


def read(view):
    return view.q4_roofline_percent(decode_only=False)
