"""Host milliseconds of the engine's prefill lane per chunk (``serving/engine.py``
``step`` up to its decode lane, one lane: admission, the chunk's trunk
call, its head and pick, its feedback), synchronized at both ends: the
window's total over its chunks."""


def read(view):
    chunks = [it for it in view.chunks() if "prefill_s" in it.parts]
    if not chunks:
        return None
    return 1e3 * sum(it.parts["prefill_s"] for it in chunks) / len(chunks)
