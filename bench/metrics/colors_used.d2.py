"""Conflict rounds and the first-fit pick (`ColoringResult.n_colors`):
colors of the traced window's distance-2 requests, their mean.  The
distance-2 cell's own reading of `colors_used`: it differs by a color from seed
to seed, a spread that no end-to-end bound holds."""


def read(record):
    colors = record.get("colors")
    return sum(colors) / len(colors) if colors else None
