"""setup_s: seconds from the start of the run's process to its first
timed unit (imports, the kernel library's build or load, the data, the
trainer and its warm-up), host clock."""


def read(r):
    return r.setup_s
