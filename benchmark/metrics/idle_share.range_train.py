"""The device's idle share of the range train cell's traced window, in percent: 1 − the union of its kernel, memset and memcpy intervals over the window's wall time."""


def read(t: dict):
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
