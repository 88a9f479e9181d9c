"""serve_rows_per_batch: the engine's batched rows per batch over the
window, from ``GET /v1/stats`` before and after it."""


def read(record):
    before, after = record["stats"]
    batches = after["batches"] - before["batches"]
    return (after["batched_rows"] - before["batched_rows"]) / batches if batches else None
