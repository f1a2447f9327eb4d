"""setup.build_s: host seconds of the Simulator's constructor (topology,
the numpy graph build, the state and the edge and answer tables), the
host clock around it ending in a synchronize. Moves setup_s."""


def read(ctx):
    return ctx["run"].build_s
