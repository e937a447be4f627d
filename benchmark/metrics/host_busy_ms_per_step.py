"""Host milliseconds a step spends working: each traced step's host range
less the time its launches waited for room in the card's full launch
queue (the profiler's "Command Buffer Full"), the mean over the steps.
Where it is well under ``step_ms`` the host is ahead of the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    busy = ctx.trace.host_busy_ns()
    return sum(busy) / len(busy) / 1e6
