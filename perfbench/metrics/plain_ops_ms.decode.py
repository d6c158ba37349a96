"""Device milliseconds per decode step of every operation that is not a
kernel of the port's CUDA libraries (the model's plain torch ops:
``models/transformer.py``, ``models/attention.py``, norms, RoPE, copies),
over the profiled slice's decode-only iterations."""


def read(view):
    total, n = 0.0, 0
    for it, ops in view.traced():
        if it.prefill is not None or not it.rows:
            continue
        total += sum(e - s for name, s, e in ops if not view.is_port(name))
        n += 1
    return total * 1e-6 / n if n else None
