"""host_syncs: the program's calls that wait for the device's queue per
step, exact: its ``rsa.sync.*`` ranges in the traced steps (the kernels'
list checks, the plan's and the text refiner's scalars copied from host
memory, each step's end, TeaCache's signal, the tp vote) over the
steps."""

from perfbench.spans import SYNC, ranges


def read(r):
    n = len(ranges(r, SYNC))
    if not n or not r.steps:
        return None
    return n / r.steps
