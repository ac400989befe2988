"""Mean queries per kernel pass that the request frontend coalesced in the
window: its ``info()["batch_histogram"]``, the window's difference."""


def read(ctx):
    fe = ctx.get("frontend")
    if not fe or not fe["passes"]:
        return None
    return fe["queries"] / fe["passes"]
