"""The Q4_0 kernels' share of their roofline on decode (``kernels/q4_matmul.py``
+ ``csrc/q4_matmul.cu``): Σ the bound of every Q4_0 launch of the profiled
slice's decode-only iterations (``harness/work.py``: Q4_0 bytes, x and y
once, against HBM and the bfloat16 peak) over Σ their device time.
Percent."""


def read(view):
    return view.q4_roofline_percent(decode_only=True)
