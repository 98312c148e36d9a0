"""What every adapter reads of a cell: the configuration as the cell runs
it, and the steps of an epoch.  The program's objects and the reference's
come from the adapter that the configuration names
(`adapters/<name>.py`)."""
from __future__ import annotations

import copy


def run_config(cell) -> dict:
    """The configuration as this cell runs it: the frozen config with the
    workload's raster overrides."""
    cfg = copy.deepcopy(cell.config)
    cfg["renderer"]["raster_params"].update(
        cell.workload.get("raster_overrides", {}))
    return cfg


def steps_per_epoch(cell) -> int:
    return cell.dataset["n_views"] // int(cell.config["training"]["batch_size"])
