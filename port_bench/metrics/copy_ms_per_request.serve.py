"""The device time of a request's host-to-device and device-to-host
copies (the session's input and answer), ms per traced request."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(r"HtoD|DtoH", kind="copy")
    if n == 0:
        return None
    return 1e3 * seconds / ctx.traced_requests
