"""plan.idle_unnamed: the share (%) of the traced stretch in which no
operation ran on the card and no span of the program was open: the idle
time that the program's spans do not name (torch.profiler's clock)."""

from portbench.spans import unnamed_idle_share


def read(run):
    return unnamed_idle_share(run)
