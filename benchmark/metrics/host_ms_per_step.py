"""Host milliseconds a step: the benchmark's own span around each step
call, from the call to its return, the mean over the window."""


def read(ctx):
    if not ctx.host_ns:
        return None
    return sum(ctx.host_ns) / len(ctx.host_ns) / 1e6
