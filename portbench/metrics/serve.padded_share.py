"""Padded slots over slots run, from the service's stats() over the traced
part of the window (the first ``trace_requests`` requests)."""


def read(run):
    s = run.traced_stats
    if run.kind != "serve_open" or not s or not s["batches"]:
        return None
    return 100.0 * s["padded_slots"] / (s["batches"] * s["batch_size"])
