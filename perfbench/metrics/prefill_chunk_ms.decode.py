"""Host milliseconds of the engine's prefill lane per chunk in the closed
loop (a new request's prompt, one chunk an iteration: admission, the
chunk's eager trunk call, its head and pick, its feedback), synchronized
at both ends: the window's total over its chunks.  The 5-8% of
iterations that carry one take about twice a decode step, which
``decode_tok_s`` pays."""


def read(view):
    chunks = [it for it in view.chunks() if "prefill_s" in it.parts]
    if not chunks:
        return None
    return 1e3 * sum(it.parts["prefill_s"] for it in chunks) / len(chunks)
