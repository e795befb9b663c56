"""The device's idle share of the traced window of a train cell: 1 minus
the union of the kernels' and copies' intervals, in percent."""


def read(run):
    return 100.0 * run.profile.idle_share()
