"""The operations in one iteration of the range train loop (the view and the step) that make the host wait for the card (torch's sync debug mode), a count."""


def read(t: dict):
    return t.get("host_waits")
