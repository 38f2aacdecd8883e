"""setup_s: process start to the origin of the traffic (the first due time
is drawn after it): imports, the kernel library's build or load, the
weights made on the card, the warm-up of the cell's prefill shapes, the
page pool and the decode chunk's graph capture."""


def read(run):
    return run.setup_s
