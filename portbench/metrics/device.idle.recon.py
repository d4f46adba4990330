"""device.idle.recon: the share (%) of the traced stretch in which no
operation ran on the card (torch.profiler)."""

from portbench.trace import idle_share


def read(run):
    return idle_share(run)
