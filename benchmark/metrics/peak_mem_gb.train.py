"""Peak allocated device memory over the traced steps, after a reset, in GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
