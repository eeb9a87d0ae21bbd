"""setup_s: seconds from the process's start to the window's opening
(loading, weights, kernel builds, warm-up), on the host's clock."""


def read(record):
    return record.get("setup_s")
