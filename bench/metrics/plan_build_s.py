"""Plan (`core/plan.py::get_plan` -> `ColoringPlan.__init__`): seconds of
the build in set-up, on the harness's clock, ended by a device sync."""


def read(record):
    return record.get("plan_build_s")
