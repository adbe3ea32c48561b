"""The device during bulk embedding: percent of the traced window in which no
device operation ran (1 − the union of operation intervals / the window)."""


def read(t):
    return t.idle_share()
