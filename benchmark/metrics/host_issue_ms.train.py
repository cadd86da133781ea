"""host_issue_ms.train: the host's ms to enqueue one train step, timed
by the host clock around the window's engine calls, before the
synchronize that closes it."""


def read(record):
    if record["kind"] != "train" or record["steps"] <= 0:
        return None
    return 1e3 * record["issue_s"] / record["steps"]
