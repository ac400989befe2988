"""Bytes of the served stream per live non-zero: the facade's
``stats().bytes_per_nnz``."""


def read(ctx):
    if ctx.get("frontend") is not None:
        return None
    return ctx["stats"]["bytes_per_nnz"]
