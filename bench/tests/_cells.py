"""Every cell the configurations and mixes here make, whether or not
``BENCHMARK.json`` lists it yet: the tests drive each one."""

CELLS = {
    "hex252_d1.cold": ("hex252_d1", "cold", 1),
    "hex252_d2.cold": ("hex252_d2", "cold", 1),
    "hex252_d1.timesteps": ("hex252_d1", "timesteps", 1),
    "hex252_d1_x4.cold": ("hex252_d1_x4", "cold", 4),
}

# Mixes that the tests give inline, having no file under ``bench/traffic``:
# a partial recoloring, each request 10% from the last answer.
MIXES = {"timesteps": {"entry": "plan_run", "recolor_fraction": 0.1}}


def cell(name: str) -> dict:
    config, traffic, chips = CELLS[name]
    return {"name": name, "config": config, "traffic": traffic, "chips": chips}


def mix(name: str) -> dict | None:
    """The inline mix of cell ``name``, or ``None`` where its file is read."""
    return MIXES.get(CELLS[name][1])
