"""The operations in one scan of the eval CLI's loop that make the host wait for the card (torch's sync debug mode), a count."""


def read(t: dict):
    return t.get("host_waits")
