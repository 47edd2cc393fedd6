"""Share of the traced unit's window in which the device ran nothing."""

from benchlib.readers import idle_share


def read(ctx):
    return idle_share(ctx)
