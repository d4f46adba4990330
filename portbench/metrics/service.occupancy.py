"""service.occupancy: the share (%) of the batch slots that PlannerService
filled with requests in the window, by its own counters (``stats()``:
requests over batches times the batch size)."""


def read(run):
    if not run.batches:
        return None
    return 100.0 * run.requests / (run.batches * run.traffic["batch_size"])
