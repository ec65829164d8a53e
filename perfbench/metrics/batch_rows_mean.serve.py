"""Rows a batcher window carried: the change in `BatcherStats.requests`
over the change in `batches` across the window (the whole-utterance
requests; streams run outside the windows)."""


def read(run):
    b = run.counters.get("batches", 0)
    return run.counters["requests"] / b if b else None
