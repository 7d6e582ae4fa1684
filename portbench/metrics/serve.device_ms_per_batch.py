"""Device busy time of the traced window over the batches the service
settled in it (stats()): the device work one served batch costs."""


def read(run):
    if run.kind != "serve_open" or run.trace is None \
            or run.trace.busy_s() <= 0 or run.traced_batches <= 0:
        return None
    return 1e3 * run.trace.busy_s() / run.traced_batches
