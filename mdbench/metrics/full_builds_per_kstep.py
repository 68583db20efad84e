"""Rebuild: the program's count of full neighbour-list builds
(``MDSystem.rebuild_branches["full"]``) over the window and the
profiled stretch, per thousand MD steps."""


def read(ctx):
    if not ctx.steps:
        return None
    return 1e3 * ctx.run.branches["full"] / ctx.steps
