"""Real (unpadded) documents ranked in the window, over the window's seconds
(host clock, from the first request's call to the last one's return)."""


def read(ctx: dict) -> float:
    return ctx["docs"] / ctx["window_s"]
